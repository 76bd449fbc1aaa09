"""Checkpointing: full train state as numpy arrays, sharding-aware, with a
best-PER pointer.

Reference capability: Keras ModelCheckpoint HDF5 weights with best-on-dev-PER
selection + manual resume (SURVEY.md §5 checkpoint/resume; mount empty).
Here each step is one directory holding the complete state (params, opt
state, step, PRNG key) as ``state.npz`` plus a ``manifest.json`` of dtypes
and shapes. A step is written under a temporary name and renamed into place,
so a step directory that exists is complete and a killed save leaves only a
temporary directory that every reader ignores. ``best.json`` points at the
dev-PER-selected step. Layout: docs/checkpoint_layout.md.

Multi-process: every process takes part in gathering sharded arrays, process
0 writes, and restore places each array into the target's sharding.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np

from qasr.configs import Config

_TMP_PREFIX = ".tmp-"


def _key(path) -> str:
    """'params/qconv_0/kernel'-style name of a tree path."""
    parts = []
    for k in path:
        parts.append(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))))
    return "/".join(parts)


def _to_host(x) -> np.ndarray:
    """A leaf as a full host array; collective when it spans processes."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _sync(tag: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)


class CheckpointManager:
    def __init__(self, cfg: Config, *, write_config: bool = True):
        self.dir = os.path.abspath(cfg.train.checkpoint_dir)
        self.keep = cfg.train.keep_checkpoints
        os.makedirs(self.dir, exist_ok=True)
        # serialize the config next to the checkpoints (reproducibility);
        # read-only consumers (qasr.infer) pass write_config=False so they
        # never clobber the training run's record
        if write_config and jax.process_index() == 0:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                f.write(cfg.to_json())

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, str(step))

    def save(self, step: int, state, *, dev_per: float | None = None,
             data_state: dict | None = None):
        """Write ``state`` as step ``step``; returns when it is on disk."""
        flat, _ = jax.tree_util.tree_flatten_with_path(state)
        arrays = {_key(p): _to_host(x) for p, x in flat}
        if jax.process_index() == 0:
            self._write(step, arrays)
            if data_state is not None:
                with open(os.path.join(self.dir, f"data_state_{step}.json"), "w") as f:
                    json.dump(data_state, f)
            if dev_per is not None:
                self._update_best(step, dev_per)
            self._collect_garbage()
        _sync(f"qasr_ckpt_save_{step}")

    def _write(self, step: int, arrays: dict) -> None:
        tmp = os.path.join(self.dir, f"{_TMP_PREFIX}{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # stored as raw unsigned words of the same width, so dtypes numpy
        # cannot name (bfloat16, PRNG key data) round-trip bit for bit
        manifest = {
            k: {"dtype": str(a.dtype), "shape": list(a.shape)}
            for k, a in arrays.items()
        }
        raw = {
            k: np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")
            for k, a in arrays.items()
        }
        with open(os.path.join(tmp, "state.npz"), "wb") as f:
            np.savez(f, **raw)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def _update_best(self, step: int, dev_per: float) -> None:
        best_path = os.path.join(self.dir, "best.json")
        best = {"step": -1, "dev_per": float("inf")}
        if os.path.exists(best_path):
            with open(best_path) as f:
                best = json.load(f)
        if dev_per < best["dev_per"]:
            with open(best_path, "w") as f:
                json.dump({"step": step, "dev_per": dev_per}, f)

    def _collect_garbage(self) -> None:
        """Keep the newest ``keep_checkpoints`` steps."""
        steps = self.all_steps()
        for step in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            data = os.path.join(self.dir, f"data_state_{step}.json")
            if os.path.exists(data):
                os.remove(data)

    def wait(self):
        """Saves are synchronous; kept so callers need not know that."""

    def all_steps(self) -> list[int]:
        """Complete steps, oldest first."""
        return sorted(
            int(name) for name in os.listdir(self.dir)
            if name.isdigit() and os.path.isdir(self._step_dir(int(name)))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        best_path = os.path.join(self.dir, "best.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                return json.load(f)["step"]
        return None

    def _read(self, step: int, target, prefix: str = ""):
        """Step ``step``'s arrays shaped and placed like ``target``, whose
        leaves are arrays or ``jax.ShapeDtypeStruct`` (``prefix`` names the
        subtree of the saved state that ``target`` mirrors)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat, treedef = jax.tree_util.tree_flatten_with_path(target)
        leaves = []
        with np.load(os.path.join(d, "state.npz")) as npz:
            for path, leaf in flat:
                key = prefix + _key(path)
                if key not in manifest:
                    raise KeyError(f"{key!r} not in checkpoint step {step} ({d})")
                meta = manifest[key]
                dtype = np.dtype(leaf.dtype)
                if meta["dtype"] != str(dtype) or tuple(meta["shape"]) != tuple(leaf.shape):
                    raise ValueError(
                        f"{key!r}: checkpoint has {meta['dtype']}{meta['shape']}, "
                        f"target wants {dtype}{list(leaf.shape)}"
                    )
                host = npz[key].view(dtype).reshape(leaf.shape)
                sharding = getattr(leaf, "sharding", None)
                if sharding is None:
                    leaves.append(jax.numpy.asarray(host))
                else:
                    leaves.append(
                        jax.make_array_from_callback(
                            host.shape, sharding, lambda idx, h=host: h[idx]
                        )
                    )
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def restore(self, step: int, target_state):
        """Restore into the structure, dtypes and shardings of `target_state`."""
        return self._read(step, target_state)

    def restore_params(self, step: int, cfg: Config, sample_features):
        """Params-only restore for inference.

        The target structure comes from `jax.eval_shape`, so nothing is
        initialized on device, and only the params' members of the archive
        are read: the optimizer moments (2/3 of the bytes) stay on disk.
        """
        import jax.numpy as jnp

        from qasr.train.state import create_train_state

        feats = jax.ShapeDtypeStruct(np.shape(sample_features), jnp.float32)
        abstract = jax.eval_shape(
            lambda f: create_train_state(cfg, jax.random.PRNGKey(0), f), feats
        )
        return self._read(step, abstract.params, prefix="params/")

    def restore_data_state(self, step: int) -> dict | None:
        path = os.path.join(self.dir, f"data_state_{step}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None
