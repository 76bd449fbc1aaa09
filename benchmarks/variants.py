#!/usr/bin/env python
"""Compare quaternion compute-path variants on a full flagship train step.

Times the timit_qcnn training step (fwd+bwd+Adam) for each Hamilton-product
implementation — block (reference strategy), the 10- and 8-product
schemes, packed and stacked — plus the equal-feature-map real CNN, using
bench.py's
difference-quotient harness. Use this to pick the preset's default path on
real hardware.

Usage: python benchmarks/variants.py [--batch 16] [--t 256] [--repeats 3]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="timit_qcnn")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--arms",
        default="auto,block,real_cnn",
        help="comma list of arm names (see `overrides` below)",
    )
    args = ap.parse_args()

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import _Arm, _make_batch, bench_arms
    from qasr.configs import get_config

    b, t, f = args.batch, args.t, 40
    base = get_config(args.preset).override(**{"data.batch_size": b})
    batch = _make_batch(b, t, f, base.model.vocab, 48)

    overrides = {
        "auto": {},  # stacked F-major chain for fat layers (see layers.py)
        "stacked": {"model.op_variant": "stacked"},  # XLA 10-product stacked
        "stacked8": {"model.op_variant": "stacked8"},  # XLA rank-8 stacked
        "stacked8g": {"model.op_variant": "stacked8g"},  # rank-8, one grouped conv
        "legacy_auto": {"model.op_variant": "legacy_auto"},  # pre-stacked auto
        "block": {"model.op_variant": "block"},
        "fast": {"model.op_variant": "fast"},
        "fast10": {"model.op_variant": "fast10"},
        "dense_fast": {"model.dense_variant": "fast"},  # conv stays auto
        "dense_fast8": {"model.dense_variant": "fast8"},  # rank-8 dense, conv auto
        # first dense consumes the stacked conv output (no exit transpose),
        # rank-8 at K = F*C; remaining dense layers stay on the block GEMM
        "dense_fast8_st": {"model.dense_variant": "fast8_stacked"},
        "real_cnn": {"model.arch": "real_cnn"},
        # config-4 (qlstm preset) arms: equal-real-width LSTM ablation and
        # the projection-path A/B (with a qlstm preset, "auto" = rank-8
        # recurrent, input projection by M = B*T; "fast8" = rank-8 input
        # only; "block" = all-block)
        "real_lstm": {"model.arch": "real_lstm"},
        "fast8_recurrent": {"model.op_variant": "fast8_recurrent"},  # == auto
        "qlstm_fast8_input": {"model.op_variant": "fast8"},
    }
    arms = {}
    for name in args.arms.split(","):
        print(f"building arm {name} ...", file=sys.stderr)
        arms[name] = _Arm(base.override(**overrides[name]), batch)

    times = bench_arms(arms, repeats=args.repeats)
    audio_s = b * t * 0.010
    ref = times.get("real_cnn")
    out = {
        name: {
            "s_per_step": round(dt, 5),
            "audio_s_per_s": round(audio_s / dt, 1),
            **({"vs_real_cnn": round(ref / dt, 3)} if ref else {}),
        }
        for name, dt in times.items()
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
