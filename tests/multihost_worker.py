"""Worker entry + shared workload for the 2-process multi-host parity test.

Run as ``python tests/multihost_worker.py <pid> <nproc> <port> <out.json>``
from tests/test_multihost.py. Each process brings up 4 fake CPU devices and
joins a jax.distributed world of 8, then runs the exact same workload the
single-process arm runs on its local 8-device mesh: sharded DP×TP training
steps through the multi-host batch adapter, then a sharded beam-decode
evaluation whose PER counters aggregate across processes
(SURVEY.md §2c P6, §4 test 6).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_workload(
    num_steps: int = 4,
    ckpt_dir: str | None = None,
    num_examples: int = 16,
):
    """Train + beam-eval the tiny synthetic config on a (data=4, model=2)
    mesh built from all global devices. Works single- or multi-process:
    every process sees the same host-replicated global batches (same dataset
    walk), and the step adapters slice per-host rows internally.

    ``num_examples`` not divisible by the batch size (e.g. 13 vs batch 8)
    makes the eval epoch end in a REMAINDER batch whose pad rows land on
    the LAST data-axis host — the 4-process variant uses this to drive the
    uneven-last-host-batch case through the sharded beam path (round-5
    verdict task)."""
    import jax

    from qasr.configs import get_config
    from qasr.data import SyntheticDataset, epoch_iterator
    from qasr.parallel import (
        create_sharded_train_state,
        make_mesh,
        make_sharded_beam_decode_step,
        make_sharded_train_step,
    )
    from qasr.train.loop import evaluate
    from qasr.train.step import optax_global_norm

    cfg = get_config("tiny_synthetic")
    ds = SyntheticDataset(
        vocab=cfg.model.vocab,
        n_mels=cfg.data.n_mels,
        num_examples=num_examples,
        seed=0,
    )
    batches = []
    while len(batches) < num_steps:
        for b in epoch_iterator(ds, cfg.data, train=False):
            batches.append(b)
            if len(batches) == num_steps:
                break

    mesh = make_mesh(-1, 2)
    state, shardings = create_sharded_train_state(
        cfg, jax.random.PRNGKey(0), batches[0]["features"], mesh
    )
    train_step = make_sharded_train_step(cfg, mesh, shardings, batches[0])
    losses = []
    for b in batches:
        state, m = train_step(state, b)
        losses.append(float(m["loss"]))

    pnorm = float(jax.jit(optax_global_norm)(state.params))

    # multi-host-safe checkpoint round trip (SURVEY.md §5): every process
    # participates in the save/restore of the sharded state; the
    # restored state must reproduce the live one exactly and train on
    ckpt_restore_diff = None
    resumed_loss = None
    if ckpt_dir is not None:
        from qasr.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(
            cfg.override(**{"train.checkpoint_dir": ckpt_dir})
        )
        ckpt.save(int(state.step), state)
        ckpt.wait()
        fresh, _ = create_sharded_train_state(
            cfg, jax.random.PRNGKey(99), batches[0]["features"], mesh
        )
        restored = ckpt.restore(ckpt.latest_step(), fresh)
        diffs = jax.tree_util.tree_map(
            lambda a, b: float(jnp_abs_max(a, b)), restored.params, state.params
        )
        ckpt_restore_diff = max(jax.tree_util.tree_leaves(diffs))
        _, m_r = train_step(restored, batches[0])
        resumed_loss = float(m_r["loss"])

    beam_step = make_sharded_beam_decode_step(cfg, mesh, shardings, batches[0])
    ev = evaluate(cfg, state.params, ds, None, beam_step=beam_step)

    # TP across the process boundary: interleave the device grid so the
    # model axis spans both hosts — weight all-gathers ride the inter-
    # process link (gloo here, ICI/DCN on real slices), not just intra-host
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    grid = np.asarray(jax.devices()).reshape(4, 2).T  # model axis mixes hosts
    mesh_x = Mesh(grid, ("data", "model"))
    state_x, sh_x = create_sharded_train_state(
        cfg, jax.random.PRNGKey(0), batches[0]["features"], mesh_x
    )
    # this mesh interleaves processes along the model axis, so the host-
    # batch adapter's process-contiguous-rows contract does not apply:
    # build the global batch explicitly (each data row spans both hosts,
    # so every process passes the full host-replicated batch)
    step_x = make_sharded_train_step(
        cfg, mesh_x, sh_x, batches[0], adapt_host_batches=False
    )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        gb = multihost_utils.host_local_array_to_global_array(
            dict(batches[0]), mesh_x, P("data")
        )
    else:
        gb = batches[0]
    _, m_x = step_x(state_x, gb)
    tp_cross_loss = float(m_x["loss"])

    # and the adapter must REFUSE this mesh rather than silently diverge
    adapter_guard = True
    if jax.process_count() > 1:
        try:
            make_sharded_train_step(cfg, mesh_x, sh_x, batches[0])
            adapter_guard = False
        except ValueError:
            pass

    return {
        "adapter_guard": adapter_guard,
        "process_count": jax.process_count(),
        "losses": losses,
        "pnorm": pnorm,
        "eval_loss": ev["loss"],
        "per": ev["per"],
        "tp_cross_loss": tp_cross_loss,
        "ckpt_restore_diff": ckpt_restore_diff,
        "resumed_loss": resumed_loss,
    }


def jnp_abs_max(a, b):
    import jax.numpy as jnp

    return jnp.max(jnp.abs(a - b))


def main():
    pid, nproc, port, out_path = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )

    import jax

    n_local = 8 // nproc  # 8 global devices regardless of world size
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n_local)
    jax.config.update("jax_threefry_partitionable", True)

    from qasr.parallel import initialize_multihost

    initialize_multihost(
        f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == n_local
    assert jax.device_count() == 8

    num_examples = int(sys.argv[5]) if len(sys.argv) > 5 else 16
    # shared checkpoint dir: all processes write/read the same tree
    result = run_workload(
        ckpt_dir=os.path.join(os.path.dirname(os.path.abspath(out_path)), "ckpt"),
        num_examples=num_examples,
    )
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
