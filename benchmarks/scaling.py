#!/usr/bin/env python
"""DP scaling-efficiency benchmark (BASELINE.json north-star metric:
">= 80% audio-seconds/s scaling efficiency from 1 chip -> 1 host -> N hosts").

Weak-scales the flagship train step over growing data-parallel submeshes of
whatever devices exist (the cards of a host; the 8-device CPU mesh in CI —
wall-clock there checks the logic, not the interconnect) and reports
audio-s/s/chip per mesh size plus efficiency vs 1 device.

Usage:
  python benchmarks/scaling.py                      # devices as available
  JAX_PLATFORMS=cpu python benchmarks/scaling.py --cpu-devices 8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(cfg, mesh, batch, *, reps=3, k_small=4, k_big=20):
    import statistics

    import jax

    from qasr.parallel import (
        create_sharded_train_state,
        make_sharded_train_step,
        shard_batch,
    )

    state, shardings = create_sharded_train_state(
        cfg, jax.random.PRNGKey(0), batch["features"], mesh
    )
    step_fn = make_sharded_train_step(cfg, mesh, shardings, batch)
    sb = shard_batch(mesh, batch)

    cur = state  # the step donates its input state: always carry it forward

    def run(k):
        nonlocal cur
        m = None
        t0 = time.perf_counter()
        for _ in range(k):
            cur, m = step_fn(cur, sb)
        loss = float(m["loss"])  # single sync at the end
        assert loss == loss, "non-finite loss"
        return time.perf_counter() - t0

    run(2)  # compile + warm
    est = []
    for _ in range(reps):
        a, b = run(k_small), run(k_big)
        est.append((b - a) / (k_big - k_small))
    return statistics.median(est)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="timit_qcnn")
    ap.add_argument("--base-batch", type=int, default=8, help="batch per device")
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--cpu-devices", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import _make_batch
    from qasr.configs import get_config
    from qasr.parallel import make_mesh

    devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    frame_s = 0.010
    base = get_config(args.preset)

    results = {}
    for n in sizes:
        b = args.base_batch * n  # weak scaling: constant per-chip batch
        cfg = base.override(**{"data.batch_size": b})
        batch = _make_batch(b, args.t, base.data.n_mels, base.model.vocab, 48)
        mesh = make_mesh(n, 1, devices=devices[:n])
        dt = measure(cfg, mesh, batch, reps=args.reps)
        per_chip = b * args.t * frame_s / dt / n
        results[n] = per_chip
        print(
            f"# {n} dev: {dt*1e3:.2f} ms/step, {per_chip:.1f} audio-s/s/chip",
            file=sys.stderr,
        )

    base_rate = results[sizes[0]]
    out = {
        "metric": "dp_weak_scaling",
        "platform": devices[0].platform,
        "audio_s_per_s_per_chip": {str(k): round(v, 1) for k, v in results.items()},
        "efficiency_vs_1dev": {
            str(k): round(v / base_rate, 3) for k, v in results.items()
        },
    }
    if devices[0].platform == "cpu":
        out["note"] = (
            "fake CPU mesh shares one host's cores: weak-scaling efficiency "
            "is meaningless here (total compute grows n-fold on fixed "
            "silicon); this run only validates the SPMD logic"
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
