#!/usr/bin/env python
"""Micro-probe: quaternion dense compute paths (block vs 10-product vs real).

Same harness as probe_conv.py (chained fori_loop + difference quotient).
Shapes default to the flagship dense stack: M = B*T rows, K quaternion in,
N quaternion out. The 10-product dense's per-product GEMM is [M, K] x [K, N]
(width N, not 4N), so like the conv its products are narrow below N = 128.

CAVEAT: flagship dense ops are short, so host-clock noise can be a large
part of the quotient. For dense-path decisions use the full-train-step A/B
instead: `variants.py --arms auto,dense_fast`.

Usage: python benchmarks/probe_dense.py [--m 4096] [--shapes 832:256,256:256] [--grad]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_conv import make_chain, time_chain  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--shapes", default="832:256,256:256")
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--arms", default="block,fast,real")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.ops.qlinalg import qdense, qdense_fast

    def real_dense(x, w):
        return jax.lax.dot_general(
            x, w, dimension_numbers=(((1,), (0,)), ((), ()))
        ).astype(x.dtype)

    rng = jax.random.PRNGKey(0)
    results = {}
    for spec in args.shapes.split(","):
        k, n = (int(s) for s in spec.split(":"))
        kx, kw = jax.random.split(jax.random.fold_in(rng, k * 100003 + n))
        # chains need shape-preserving ops: use square [4K, 4K]-ish only when
        # K == N; otherwise chain via x -> op -> project back with a fixed map
        x = jax.random.normal(kx, (args.m, 4 * k), jnp.bfloat16)
        wq = jax.random.normal(kw, (4, k, n), jnp.bfloat16) * 0.05
        wr = jax.random.normal(kw, (4 * k, 4 * n), jnp.bfloat16) * 0.05
        back = jax.random.normal(kw, (4 * n, 4 * k), jnp.bfloat16) * 0.05

        def wrap(op):
            def f(x, w):
                y = op(x, w)
                return jax.lax.dot_general(
                    y, back, dimension_numbers=(((1,), (0,)), ((), ()))
                ).astype(x.dtype)

            return f

        arms = {
            "block": (wrap(qdense), wq),
            "fast": (wrap(qdense_fast), wq),
            "real": (wrap(real_dense), wr),
        }
        row = {}
        for name in args.arms.split(","):
            op, w = arms[name]
            chain = make_chain(op, x, w, args.grad)
            dt = time_chain(chain, x, w)
            row[name] = round(dt * 1e3, 4)
            print(f"K={k} N={n} {name}: {dt*1e3:.4f} ms", file=sys.stderr)
        if "real" in row:
            for name in list(row):
                if name != "real":
                    row[f"{name}_vs_real"] = round(row["real"] / row[name], 3)
        results[spec] = row
    print(json.dumps({"grad": args.grad, "m": args.m, "results": results}))


if __name__ == "__main__":
    main()
