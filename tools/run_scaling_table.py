#!/usr/bin/env python
"""Scaling-efficiency acceptance table: audio-s/s/chip at 1 chip, 1 host,
and N hosts, on whatever real mesh exists (round-5 verdict task; the
BASELINE north star asks for >= 80% efficiency 1 chip -> 1 host -> N>=2
hosts).

DP weak scaling: per-chip batch is held fixed while the mesh grows, so
perfect scaling = flat audio-s/s/chip. Measures a 1-chip run and the
full-mesh run in the same process and reports the ratio. Multi-host: start
one process per host with the usual JAX coordinator env (the script calls
``jax.distributed.initialize()`` when JAX_COORDINATOR_ADDRESS is set);
only process 0 prints.

This container has ONE real chip, so here the table has a single row and
``efficiency`` is 1.0 by construction — the artifact exists so a real
slice is drop-in. SPMD logic at N > 1 is validated separately on the fake
CPU mesh (benchmarks/scaling.py and tests/test_sharding.py).

  python tools/run_scaling_table.py [--preset timit_qcnn]
      [--b-per-chip 16] [--t 256] [--steps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(cfg, devices, b_per_chip, t, f, n_small, n_big):
    import jax
    import numpy as np

    from bench import _make_batch
    from qasr.parallel import (
        create_sharded_train_state,
        make_mesh,
        make_sharded_train_step,
        shard_batch,
    )

    n = len(devices)
    mesh = make_mesh(n, 1, devices=devices)
    cfg = cfg.override(**{"data.batch_size": b_per_chip * n})
    batch = _make_batch(b_per_chip * n, t, f, cfg.model.vocab, 48)
    state, shardings = create_sharded_train_state(
        cfg, jax.random.PRNGKey(0), batch["features"], mesh
    )
    step = make_sharded_train_step(cfg, mesh, shardings, batch)
    sbatch = shard_batch(mesh, batch)

    def run(k):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(k):
            state, m = step(state, sbatch)
        loss = float(m["loss"])  # host fetch = sync
        assert np.isfinite(loss), loss
        return time.perf_counter() - t0

    run(1)  # compile
    ts = run(n_small)
    tb = run(n_big)
    return (tb - ts) / (n_big - n_small)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="timit_qcnn")
    ap.add_argument("--b-per-chip", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--n-small", type=int, default=4)
    ap.add_argument("--n-big", type=int, default=24)
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.configs import get_config

    cfg = get_config(args.preset)
    devices = jax.devices()
    n_chips = len(devices)
    local = jax.local_device_count()
    frame_s = 0.010
    audio_per_chip = args.b_per_chip * args.t * frame_s

    rows = []
    # 1 chip (single-process only: a 1-device mesh is not addressable from
    # every host of a multi-process run)
    base = None
    if jax.process_count() == 1:
        dt1 = measure(cfg, devices[:1], args.b_per_chip, args.t, 40,
                      args.n_small, args.n_big)
        base = audio_per_chip / dt1
        rows.append({"chips": 1, "hosts": 1, "step_ms": round(dt1 * 1e3, 2),
                     "audio_s_per_s_per_chip": round(base, 1),
                     "efficiency": 1.0})
        # 1 host (all local chips)
        if local > 1:
            dtl = measure(cfg, devices[:local], args.b_per_chip, args.t, 40,
                          args.n_small, args.n_big)
            v = audio_per_chip / dtl
            rows.append({"chips": local, "hosts": 1,
                         "step_ms": round(dtl * 1e3, 2),
                         "audio_s_per_s_per_chip": round(v, 1),
                         "efficiency": round(v / base, 3)})
    # full mesh (N hosts when run under jax.distributed)
    if n_chips > local or jax.process_count() > 1 or n_chips > 1:
        dtn = measure(cfg, devices, args.b_per_chip, args.t, 40,
                      args.n_small, args.n_big)
        v = audio_per_chip / dtn
        rows.append({"chips": n_chips, "hosts": jax.process_count(),
                     "step_ms": round(dtn * 1e3, 2),
                     "audio_s_per_s_per_chip": round(v, 1),
                     "efficiency": round(v / base, 3) if base else None})

    if jax.process_index() == 0:
        print(json.dumps({
            "protocol": "dp_weak_scaling",
            "preset": args.preset,
            "b_per_chip": args.b_per_chip,
            "t_frames": args.t,
            "backend": jax.default_backend(),
            "rows": rows,
            "north_star": ">= 0.80 efficiency at every row",
        }))


if __name__ == "__main__":
    main()
