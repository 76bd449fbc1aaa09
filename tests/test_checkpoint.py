"""qasr.train.checkpoint: numpy checkpoints of the full train state."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.configs import get_config
from qasr.train.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]


def _cfg(tmp_path, keep=3):
    return get_config("tiny_synthetic").override(
        **{"train.checkpoint_dir": str(tmp_path / "ckpt"), "train.keep_checkpoints": keep}
    )


def _state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {
        "params": {"w": jax.random.normal(k, (3, 4)), "b16": jnp.arange(5, dtype=jnp.bfloat16)},
        "step": jnp.asarray(7, jnp.int32),
        "rng": jax.random.PRNGKey(seed + 1),
        "flag": jnp.asarray([True, False]),
    }


def _assert_bit_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_round_trip_bit_equal(tmp_path):
    mgr = CheckpointManager(_cfg(tmp_path))
    state = _state()
    mgr.save(3, state, data_state={"epoch": 1, "index": 2})
    assert mgr.latest_step() == 3 and mgr.all_steps() == [3]
    _assert_bit_equal(mgr.restore(3, _state(seed=9)), state)
    assert mgr.restore_data_state(3) == {"epoch": 1, "index": 2}
    manifest = json.loads((tmp_path / "ckpt" / "3" / "manifest.json").read_text())
    assert manifest["params/b16"] == {"dtype": "bfloat16", "shape": [5]}


def test_restore_rejects_mismatched_target(tmp_path):
    mgr = CheckpointManager(_cfg(tmp_path))
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = jnp.zeros((4, 3))
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(1, bad)
    bad = _state()
    bad["params"]["extra"] = jnp.zeros(())
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(1, bad)


def test_keep_checkpoints_garbage_collection(tmp_path):
    mgr = CheckpointManager(_cfg(tmp_path, keep=2))
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step), data_state={"step": step})
    assert mgr.all_steps() == [3, 4]
    assert not (tmp_path / "ckpt" / "data_state_1.json").exists()
    assert (tmp_path / "ckpt" / "data_state_4.json").exists()


def test_incomplete_step_is_ignored(tmp_path):
    mgr = CheckpointManager(_cfg(tmp_path))
    mgr.save(2, _state())
    # a save killed mid-write leaves only its temporary directory
    (tmp_path / "ckpt" / ".tmp-5").mkdir()
    (tmp_path / "ckpt" / ".tmp-5" / "state.npz").write_bytes(b"partial")
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]
    # and a later save of that step replaces it cleanly
    mgr.save(5, _state(5))
    assert mgr.all_steps() == [2, 5]
    assert not (tmp_path / "ckpt" / ".tmp-5").exists()


def test_best_pointer(tmp_path):
    mgr = CheckpointManager(_cfg(tmp_path))
    assert mgr.best_step() is None
    mgr.save(1, _state(), dev_per=0.5)
    mgr.save(2, _state(), dev_per=0.7)
    mgr.save(3, _state(), dev_per=0.4)
    assert mgr.best_step() == 3


def test_restore_params_reads_only_params(tmp_path, monkeypatch):
    from qasr.train.state import create_train_state

    cfg = _cfg(tmp_path)
    feats = np.zeros((2, 16, cfg.data.n_mels, 4), np.float32)
    state = create_train_state(cfg, jax.random.PRNGKey(0), feats)
    mgr = CheckpointManager(cfg)
    mgr.save(4, state)
    read = []
    orig = np.lib.npyio.NpzFile.__getitem__
    monkeypatch.setattr(
        np.lib.npyio.NpzFile, "__getitem__",
        lambda self, key: (read.append(key), orig(self, key))[1],
    )
    params = mgr.restore_params(4, cfg, feats)
    assert read and all(k.startswith("params/") for k in read)
    assert len(read) == len(jax.tree.leaves(state.params))
    _assert_bit_equal(params, state.params)


def test_trains_and_checkpoints_without_flax_or_orbax(tmp_path):
    code = f"""
import sys
for name in ("flax", "flax.linen", "flax.struct", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import jax
jax.config.update("jax_platforms", "cpu")
from qasr.configs import get_config
from qasr.train.checkpoint import CheckpointManager
from qasr.train.loop import train
cfg = get_config("tiny_synthetic").override(**{{
    "train.num_steps": 4, "train.checkpoint_every": 2, "train.eval_every": 1000,
    "train.log_every": 2, "train.checkpoint_dir": {str(tmp_path / "ck")!r}}})
state, metrics = train(cfg)
mgr = CheckpointManager(cfg, write_config=False)
assert mgr.all_steps() == [2, 4], mgr.all_steps()
restored = mgr.restore(4, state)
assert int(restored.step) == 4
print("OK", metrics["loss"])
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK")
