"""Real 2-process multi-host execution test (SURVEY.md §2c P6, §4 test 6).

Spawns two OS processes that join one jax.distributed world (gloo CPU
collectives, 4 fake devices each = 8 global) and run sharded DP×TP training
plus beam-decode evaluation through the multi-host batch adapter
(`qasr.parallel.train._multihost_adapter`), exercising `host_rows`,
`global↔host-local` conversion, and `aggregate_per`'s process_allgather
branch. Results must match the identical workload run single-process on this
test runner's own 8-device mesh.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "multihost_worker.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_world(tmp, nproc: int, num_examples: int):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(nproc):
        out = tmp / f"r{pid}.json"
        procs.append(
            (
                subprocess.Popen(
                    [
                        sys.executable,
                        str(WORKER),
                        str(pid),
                        str(nproc),
                        str(port),
                        str(out),
                        str(num_examples),
                    ],
                    cwd=REPO,
                    env=env,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                ),
                out,
            )
        )
    results = []
    logs = []
    for p, out in procs:
        try:
            stdout, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
        if p.returncode != 0 or not out.exists():
            raise AssertionError(
                f"worker rc={p.returncode}\n--- worker log ---\n{logs[-1][-4000:]}"
            )
        results.append(json.loads(out.read_text()))
    return results


@pytest.fixture(scope="module")
def multihost_results(tmp_path_factory):
    return _spawn_world(tmp_path_factory.mktemp("mh"), 2, 16)


@pytest.fixture(scope="module")
def multihost4_results(tmp_path_factory):
    # 4 processes x 2 fake devices; 13 examples so the eval epoch ends in a
    # remainder batch whose pad rows land on the LAST data-axis host — the
    # uneven-last-host-batch case through the sharded beam path
    return _spawn_world(tmp_path_factory.mktemp("mh4"), 4, 13)


class TestTwoProcessParity:
    def test_both_processes_agree(self, multihost_results):
        r0, r1 = multihost_results
        assert r0["process_count"] == 2 and r1["process_count"] == 2
        # replicated metrics must be bit-identical across hosts
        np.testing.assert_array_equal(r0["losses"], r1["losses"])
        assert r0["pnorm"] == r1["pnorm"]
        # PER counters pass through aggregate_per (allgather) on both hosts
        assert r0["per"] == r1["per"]
        assert r0["eval_loss"] == pytest.approx(r1["eval_loss"], rel=1e-6)
        # the cross-process-TP step (model axis spanning both hosts) ran
        # and produced identical replicated loss on both
        assert np.isfinite(r0["tp_cross_loss"])
        assert r0["tp_cross_loss"] == r1["tp_cross_loss"]
        # the host-batch adapter refuses process-interleaved meshes
        assert r0["adapter_guard"] and r1["adapter_guard"]
        # multi-host checkpoint round trip: exact params back, training resumes
        assert r0["ckpt_restore_diff"] == 0.0
        assert r1["ckpt_restore_diff"] == 0.0
        assert r0["resumed_loss"] == r1["resumed_loss"]
        assert np.isfinite(r0["resumed_loss"])

    def test_matches_single_process(self, multihost_results, tmp_path):
        from tests.multihost_worker import run_workload

        single = run_workload(ckpt_dir=str(tmp_path / "ckpt"))
        assert single["process_count"] == 1
        assert single["ckpt_restore_diff"] == 0.0
        r0 = multihost_results[0]
        # same global batches, same mesh shape -> same training trajectory
        # (fp reduction orderings may differ between the gloo 2-process run
        # and the single-process run, hence tolerances not equality)
        np.testing.assert_allclose(
            r0["losses"], single["losses"], rtol=2e-4, atol=1e-4
        )
        np.testing.assert_allclose(r0["pnorm"], single["pnorm"], rtol=2e-4)
        np.testing.assert_allclose(
            r0["eval_loss"], single["eval_loss"], rtol=2e-3, atol=1e-3
        )
        assert r0["per"] == pytest.approx(single["per"], abs=0.02)
        np.testing.assert_allclose(
            r0["tp_cross_loss"], single["tp_cross_loss"], rtol=2e-4, atol=1e-4
        )


class TestFourProcessParity:
    """4-process world (2 fake devices each): DP x TP with the model axis
    crossing process boundaries, plus an uneven remainder eval batch whose
    pad rows all live on the last host (round-5 verdict task)."""

    def test_all_processes_agree(self, multihost4_results):
        rs = multihost4_results
        assert all(r["process_count"] == 4 for r in rs)
        for r in rs[1:]:
            np.testing.assert_array_equal(rs[0]["losses"], r["losses"])
            assert rs[0]["pnorm"] == r["pnorm"]
            assert rs[0]["per"] == r["per"]
            assert rs[0]["eval_loss"] == pytest.approx(r["eval_loss"], rel=1e-6)
            assert rs[0]["tp_cross_loss"] == r["tp_cross_loss"]
        assert np.isfinite(rs[0]["tp_cross_loss"])
        assert all(r["adapter_guard"] for r in rs)
        assert all(r["ckpt_restore_diff"] == 0.0 for r in rs)
        assert np.isfinite(rs[0]["resumed_loss"])

    def test_matches_single_process_uneven_tail(
        self, multihost4_results, tmp_path
    ):
        from tests.multihost_worker import run_workload

        single = run_workload(
            ckpt_dir=str(tmp_path / "ckpt"), num_examples=13
        )
        assert single["process_count"] == 1
        r0 = multihost4_results[0]
        np.testing.assert_allclose(
            r0["losses"], single["losses"], rtol=2e-4, atol=1e-4
        )
        np.testing.assert_allclose(r0["pnorm"], single["pnorm"], rtol=2e-4)
        np.testing.assert_allclose(
            r0["eval_loss"], single["eval_loss"], rtol=2e-3, atol=1e-3
        )
        # the beam PER over the 13-utterance set (5 pad rows on the last
        # host) must match the single-process score exactly: each real
        # utterance scored once, pads dropped on every host
        assert r0["per"] == pytest.approx(single["per"], abs=1e-9)
        np.testing.assert_allclose(
            r0["tp_cross_loss"], single["tp_cross_loss"], rtol=2e-4, atol=1e-4
        )
