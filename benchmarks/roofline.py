#!/usr/bin/env python
"""Quaternion-conv roofline report (BASELINE.json kernel metric).

Measures achieved FLOP/s of the quaternion conv against the device's peak
(qasr.utils.profiling.DEVICE_PEAKS) and against the explicitly 4x-expanded
real conv (the reference's per-step computation, SURVEY.md §3.2).

Usage: python benchmarks/roofline.py [--variant block] [--cin 64] [--cout 64]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--f", type=int, default=13)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cout", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--variant", default="block", choices=["block", "fast", "fast10"])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from qasr.utils.compile_cache import enable_compile_cache
    from qasr.utils.profiling import conv_roofline

    enable_compile_cache()

    out = conv_roofline(
        batch=args.batch,
        t=args.t,
        f=args.f,
        cin=args.cin,
        cout=args.cout,
        dtype=args.dtype,
        variant=args.variant,
        repeats=args.repeats,
    )
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()}))


if __name__ == "__main__":
    main()
