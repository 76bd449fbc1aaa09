#!/usr/bin/env python
"""Config-5 (librispeech_large) per-device memory envelope, measured by AOT
compilation — no training run needed, so the first real LibriSpeech run is
not the first time anyone learns whether the preset fits.

For each (per-chip batch, bucket T) point, AOT-compiles the full train
step (fwd + CTC + Adam, donated state) with and without
``train.remat_convs`` and reports XLA's compiled memory stats: arguments
(params + opt state + batch) and temporaries (activations/workspace).
Peak per-device memory ~ args + temps, compared with what the device lets
JAX allocate (``memory_stats()["bytes_limit"]`` of the first device).

  python tools/memory_envelope.py [--preset librispeech_large]
      [--points 8:512,8:1024,16:512,...] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_point(cfg, b, t, remat):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qasr.train.state import build_model, build_optimizer, create_train_state
    from qasr.train.step import make_train_step

    cfg = cfg.override(
        **{
            "data.batch_size": b,
            "data.bucket_sizes": f"({t},)",
            "train.remat_convs": remat,
        }
    )
    n_mels = cfg.data.n_mels
    feats = jax.ShapeDtypeStruct((b, t, n_mels, 4), jnp.float32)
    batch = {
        "features": feats,
        "feature_lengths": jax.ShapeDtypeStruct((b,), jnp.int32),
        "labels": jax.ShapeDtypeStruct(
            (b, cfg.data.max_label_len), jnp.int32
        ),
        "label_lengths": jax.ShapeDtypeStruct((b,), jnp.int32),
    }
    state_shape = jax.eval_shape(
        lambda rng, f: create_train_state(cfg, rng, f),
        jax.random.PRNGKey(0),
        feats,
    )
    step = make_train_step(cfg)
    compiled = jax.jit(step, donate_argnums=(0,)).lower(
        state_shape, batch
    ).compile()
    ma = compiled.memory_analysis()
    return {
        "args_gb": ma.argument_size_in_bytes / 1e9,
        "temp_gb": ma.temp_size_in_bytes / 1e9,
        "total_gb": (ma.argument_size_in_bytes + ma.temp_size_in_bytes) / 1e9,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="librispeech_large")
    ap.add_argument(
        "--points",
        default="4:2048,8:2048,16:2048,16:1024,32:1024,64:512,64:2048",
        help="comma list of per-chip batch:bucketT points",
    )
    ap.add_argument("--as-json", action="store_true")
    args = ap.parse_args()

    import jax

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.configs import get_config

    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        raise SystemExit(
            f"{jax.devices()[0].device_kind} reports no memory limit; "
            "run this on the card"
        )
    budget_gb = stats["bytes_limit"] / 1e9
    print(f"device {jax.devices()[0].device_kind}: {budget_gb:.2f} GB for JAX",
          flush=True)
    cfg = get_config(args.preset)
    rows = []
    for point in args.points.split(","):
        b, t = (int(v) for v in point.split(":"))
        for remat in (False, True):
            try:
                r = measure_point(cfg, b, t, remat)
                r.update(b=b, t=t, remat=remat,
                         fits=r["total_gb"] < budget_gb * 0.95)
            except jax.errors.JaxRuntimeError as e:  # compile-time OOM
                r = {"b": b, "t": t, "remat": remat, "error": str(e)[:120]}
            rows.append(r)
            if not args.as_json:
                if "error" in r:
                    print(f"B{b} T{t} remat={int(remat)}: ERROR {r['error']}")
                else:
                    print(
                        f"B{b} T{t} remat={int(remat)}: args "
                        f"{r['args_gb']:.2f} GB + temps {r['temp_gb']:.2f} GB"
                        f" = {r['total_gb']:.2f} GB"
                        f" {'FITS' if r['fits'] else 'OOM'}"
                        f" (of {budget_gb:.1f} GB)"
                    , flush=True)
    if args.as_json:
        print(json.dumps(rows))


if __name__ == "__main__":
    main()
