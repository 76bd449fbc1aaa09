#!/usr/bin/env python
"""Micro-probe: quaternion conv compute paths across channel widths.

Times ONE conv op (fwd, and fwd+bwd via value_and_grad) for each Hamilton
path — XLA block (16 products), XLA fast (10-product grouped conv), the real
conv at equal real width (the reference's effective computation) — across
quaternion channel counts. Uses the chained-scan difference-quotient harness
(bench.py).

The point: per-product conv width is Cout (not 4*Cout), so the 10-product
scheme's products are narrow below 128 channels. This probe maps where each
path wins so layer auto-routing can be measurement-driven.

Usage: python benchmarks/probe_conv.py [--channels 64,128,256] [--grad]
"""

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_chain(op, x, w, with_grad):
    import jax
    import jax.numpy as jnp

    if with_grad:
        def loss(x, w):
            return jnp.sum(op(x, w).astype(jnp.float32) ** 2) * 1e-6

        step = jax.value_and_grad(loss, argnums=(0, 1))

        @jax.jit
        def chain(x, w, n):
            def body(_, carry):
                x, w = carry
                l, (gx, gw) = step(x, w)
                # fold grads back in so the loop carries a data dependency
                return (x + 1e-12 * gx, jax.tree.map(
                    lambda a, b: a + 1e-12 * b, w, gw))

            x, w = jax.lax.fori_loop(0, n, body, (x, w))
            return jnp.sum(x[..., :1].astype(jnp.float32))
    else:
        @jax.jit
        def chain(x, w, n):
            def body(_, x):
                return op(x, w).astype(x.dtype)

            y = jax.lax.fori_loop(0, n, body, x)
            return jnp.sum(y[..., :1].astype(jnp.float32))

    return chain


def time_chain(chain, x, w, lengths=(2, 10), repeats=3):
    import numpy as np

    float(chain(x, w, 1))  # compile
    est = []
    for _ in range(repeats):
        ts = []
        for n in lengths:
            t0 = time.perf_counter()
            v = float(chain(x, w, n))
            ts.append(time.perf_counter() - t0)
            assert np.isfinite(v)
        est.append((ts[1] - ts[0]) / (lengths[1] - lengths[0]))
    return statistics.median(est)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", default="64,128,256")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--f", type=int, default=13)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--arms", default="block,fast,real")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.ops.qlinalg import qconv, qconv_fast, qconv_fast10

    def real_conv(x, w):
        dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        return lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=dn)

    rng = jax.random.PRNGKey(0)
    results = {}
    for c in [int(s) for s in args.channels.split(",")]:
        kx, kw = jax.random.split(jax.random.fold_in(rng, c))
        x = jax.random.normal(kx, (args.batch, args.t, args.f, 4 * c), jnp.bfloat16)
        wq = jax.random.normal(kw, (4, 3, 3, c, c), jnp.bfloat16) * 0.05
        wr = jax.random.normal(kw, (3, 3, 4 * c, 4 * c), jnp.bfloat16) * 0.05
        arms = {
            "block": (qconv, wq),
            "fast": (qconv_fast, wq),
            "fast10": (qconv_fast10, wq),
            "real": (real_conv, wr),
        }
        row = {}
        for name in args.arms.split(","):
            op, w = arms[name]
            chain = make_chain(op, x, w, args.grad)
            dt = time_chain(chain, x, w)
            row[name] = round(dt * 1e3, 3)
            print(f"C={c} {name}: {dt*1e3:.3f} ms", file=sys.stderr)
        if "real" in row:
            for name in list(row):
                if name != "real":
                    row[f"{name}_vs_real"] = round(row["real"] / row[name], 3)
        results[c] = row
    print(json.dumps({"grad": args.grad, "results": results}))


if __name__ == "__main__":
    main()
