"""Parameter/batch sharding rules for DP x TP training (SURVEY.md §2c P1/P2).

Quaternion weights are stacked ``[4, *kernel, Cin, Cout]``; tensor parallelism
shards the quaternion *output-channel* dim (last axis) over the "model" mesh
axis, so every shard keeps all four Hamilton components of its channel slice —
the component structure stays intact per shard (BASELINE.json north star).
With GSPMD this behaves as weight-sharded storage + gathered compute (the
FSDP-style recipe appropriate when a layer's weights exceed one card's
memory), with all-gathers riding NVLink; gradients reduce-scatter back
automatically.

Batch arrays shard their leading dim over "data"; gradients DP-reduce via
XLA-inserted psum. The same path-based rule shards the optax moments (mu/nu
mirror the param tree, so their paths also end in "kernel").
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qasr.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _path_names(path) -> tuple[str, ...]:
    out = []
    for k in path:
        out.append(
            str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
        )
    return tuple(out)


def param_spec(path_names: tuple[str, ...], leaf) -> P:
    """PartitionSpec for one leaf, by tree path + rank.

    - (quaternion) kernels ``[..., Cin, Cout]`` -> shard Cout over "model"
    - biases / PReLU alphas ``[4*Cout]``        -> replicated (contiguous
      packed sharding would split Hamilton component blocks unevenly)
    - scalars / step / rng                      -> replicated
    """
    if "kernel" in path_names and getattr(leaf, "ndim", 0) >= 2:
        spec = [None] * leaf.ndim
        spec[-1] = MODEL_AXIS
        return P(*spec)
    return P()


def _sharding_for(mesh: Mesh, path, leaf) -> NamedSharding:
    spec = param_spec(_path_names(path), leaf)
    axis_size = mesh.shape[MODEL_AXIS]
    # only shard dims divisible by the axis size (no uneven shards)
    if spec != P() and leaf.shape[-1] % axis_size:
        spec = P()
    return NamedSharding(mesh, spec)


def tree_shardings(mesh: Mesh, tree) -> Any:
    """Tree of NamedShardings mirroring `tree` (params or full TrainState)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [_sharding_for(mesh, p, l) for p, l in flat]
    )


# aliases with intent-revealing names
param_shardings = tree_shardings
state_shardings = tree_shardings


def batch_shardings(mesh: Mesh, batch) -> Any:
    return jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, P(DATA_AXIS)), batch
    )


def shard_batch(mesh: Mesh, batch):
    sh = batch_shardings(mesh, batch)
    return jax.tree_util.tree_map(jax.device_put, batch, sh)
