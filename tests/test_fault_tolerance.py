"""Fault injection: SIGKILL a training run mid-flight, resume, verify integrity.

SURVEY.md §5: the reference has no failure handling at all (a killed Keras run
is restarted by hand from the last HDF5 file); here checkpoint/resume is a
first-class subsystem and its integrity under an *uncooperative* kill (SIGKILL
— no atexit, no flush) is what this test injects. The resumed run must pick
the latest COMPLETE step and train to the configured end.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Like tests/conftest.py, the subprocess pins CPU via jax.config.update.
_RUNNER = """
import jax, runpy, sys
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)
sys.argv = ["train.py"] + sys.argv[1:]
runpy.run_path({train_py!r}, run_name="__main__")
""".format(train_py=os.path.join(REPO, "train.py"))


def _train_cmd(ckpt_dir, num_steps, resume=False):
    cmd = [
        sys.executable, "-c", _RUNNER,
        "--preset", "tiny_synthetic",
        "--set", f"train.num_steps={num_steps}",
        "--set", "train.checkpoint_every=5",
        "--set", "train.eval_every=1000",
        "--set", "train.log_every=5",
        "--set", f"train.checkpoint_dir={ckpt_dir}",
    ]
    if resume:
        cmd.append("--resume")
    return cmd


def _complete_steps(ckpt_dir):
    """Step dirs that finished committing.

    qasr.train.checkpoint writes a step under ``.tmp-<step>`` and renames it
    to the bare digit name, so any digit-named dir holding ``state.npz`` is
    complete — the tmp dir to exclude is the dot-prefixed sibling.
    """
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if not name.isdigit() or not os.path.isfile(os.path.join(path, "state.npz")):
            continue
        steps.append(int(name))
    return sorted(steps)


def test_sigkill_and_resume(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    env = dict(os.environ)

    # Phase 1: train toward 40 steps, SIGKILL as soon as a checkpoint lands.
    proc = subprocess.Popen(
        _train_cmd(ckpt_dir, 40),
        env=env,
        cwd=REPO,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    deadline = time.time() + 300
    try:
        while time.time() < deadline:
            if _complete_steps(ckpt_dir):
                break
            if proc.poll() is not None:
                out = proc.stdout.read().decode(errors="replace")
                pytest.fail(f"train exited before any checkpoint:\n{out[-2000:]}")
            time.sleep(0.25)
        else:
            pytest.fail("no checkpoint appeared within 300s")
        # Uncooperative kill: no SIGTERM grace, no cleanup handlers run.
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0  # really was killed

    killed_at = _complete_steps(ckpt_dir)
    assert killed_at, "at least one complete checkpoint must survive the kill"

    # Phase 2: resume to a short end (the point is integrity, not length).
    out = subprocess.run(
        _train_cmd(ckpt_dir, max(killed_at) + 5, resume=True),
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, f"resume failed:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}"

    final_steps = _complete_steps(ckpt_dir)
    assert max(final_steps) > max(killed_at), (
        f"resume did not advance past the surviving step: {killed_at} -> {final_steps}"
    )
