#!/usr/bin/env python
"""Probe: can the rank-8 scheme win BELOW 128 quaternion channels?

On the previous accelerator the stacked rank-8 conv ran at 0.64x the block
path at C=64, each of the 8 product convs being only 64 channels wide. This
probe measures whether batching the 8 products into ONE conv helps:

* sep8    — 8 separate convs (the current stacked8 formulation)
* fgrp8   — one conv with feature_group_count=8: x combos packed to
            ``[B, F, T, 8*C]`` lanes, kernel ``[kh, kw, C, 8*Cout]``
* bgrp8   — one conv with batch_group_count=8: combos stacked on batch
            ``[8*B, F, T, C]``, kernel ``[kh, kw, C, 8*Cout]``
* block   — the 4x-expanded one-conv reference strategy (16 products'
            FLOPs, full 4C lanes) — the incumbent below 128

Each arm includes the recombination to 4 components so end effects match.
Usage: python benchmarks/probe_grouped.py [--c 64] [--grad]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--f", type=int, default=13)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--grad", action="store_true", help="time fwd+bwd (wrt x and w)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.ops.quaternion import O8, U8, V8
    from qasr.ops.qlinalg import qconv
    from qasr.utils.profiling import steady_state_times

    b, t, f, c = args.b, args.t, args.f, args.c
    dt = jnp.bfloat16
    kx, kw_ = jax.random.split(jax.random.PRNGKey(0))
    # stacked layout [B, 4, F, T, C] (the chain steady state)
    x_st = jax.random.normal(kx, (b, 4, f, t, c), dt) * 0.5
    w = jax.random.normal(kw_, (4, 3, 3, c, c), dt) * 0.05
    v8 = jnp.asarray(V8, dt)              # [8, 4] input-side combos
    o8 = jnp.asarray(O8, jnp.float32)     # [4, 8] output-side

    dn_sep = lax.conv_dimension_numbers(
        (b, f, t, c), (3, 3, c, c), ("NHWC", "HWIO", "NHWC")
    )

    def wc_combined(w_):
        # [P, kw, kh, Cin, Cout] (spatial swapped for the (F, T) layout)
        return jnp.einsum(
            "a...kn,pa->p...kn", jnp.swapaxes(w_, 1, 2), jnp.asarray(U8, w_.dtype)
        ).astype(dt)

    def combos(x_):
        # [B, F, T, P, C]: x̃_p = Σ_a V8[p,a] x_a (2-sparse rows)
        return jnp.einsum(
            "baftc,pa->bftpc", x_.astype(jnp.float32),
            jnp.asarray(V8, jnp.float32),
        ).astype(dt)

    def recombine(prods):
        # prods [B, F, T, P, C] f32-ish -> [B, 4, F, T, C]
        y = jnp.einsum("bftpc,qp->bqftc", prods.astype(jnp.float32), o8)
        return y.astype(dt)

    def sep8(x_, w_):
        wc = wc_combined(w_)
        xc = combos(x_)
        prods = [
            lax.conv_general_dilated(
                xc[:, :, :, p], wc[p], (1, 1), "SAME", dimension_numbers=dn_sep
            )
            for p in range(8)
        ]
        return recombine(jnp.stack(prods, axis=3))

    def fgrp8(x_, w_):
        wc = wc_combined(w_)  # [8, kw, kh, C, Cout]
        xc = combos(x_).reshape(b, f, t, 8 * c)
        wg = jnp.moveaxis(wc, 0, 3).reshape(3, 3, c, 8 * c)
        dn = lax.conv_dimension_numbers(
            (b, f, t, 8 * c), (3, 3, c, 8 * c), ("NHWC", "HWIO", "NHWC")
        )
        out = lax.conv_general_dilated(
            xc, wg, (1, 1), "SAME", dimension_numbers=dn, feature_group_count=8
        )
        return recombine(out.reshape(b, f, t, 8, c))

    def bgrp8(x_, w_):
        wc = wc_combined(w_)
        xc = combos(x_)  # [B, F, T, 8, C]
        xb = jnp.moveaxis(xc, 3, 0).reshape(8 * b, f, t, c)
        wg = jnp.moveaxis(wc, 0, 3).reshape(3, 3, c, 8 * c)
        dn = lax.conv_dimension_numbers(
            (8 * b, f, t, c), (3, 3, c, 8 * c), ("NHWC", "HWIO", "NHWC")
        )
        out = lax.conv_general_dilated(
            xb, wg, (1, 1), "SAME", dimension_numbers=dn, batch_group_count=8
        )  # [B, F, T, 8*Cout]
        return recombine(out.reshape(b, f, t, 8, c))

    def block(x_, w_):
        # packed reference-strategy conv (equal-FLOP real CNN)
        xp = jnp.moveaxis(x_, 1, 3).reshape(b, f, t, 4 * c)
        xp = jnp.swapaxes(xp, 1, 2)  # [B, T, F, 4C] (qconv's layout)
        y = qconv(xp, w_, padding="SAME")
        y = jnp.swapaxes(y, 1, 2).reshape(b, f, t, 4, c)
        return jnp.moveaxis(y, 3, 1)

    arms_fns = {"sep8": sep8, "fgrp8": fgrp8, "bgrp8": bgrp8, "block": block}

    def make_timed(fn):
        if args.grad:
            def step(x_, w_):
                l, (gx, gw) = jax.value_and_grad(
                    lambda a, b_: jnp.sum(fn(a, b_).astype(jnp.float32) ** 2),
                    argnums=(0, 1),
                )(x_, w_)
                return l + jnp.sum(gx.astype(jnp.float32) ** 2) + jnp.sum(
                    gw.astype(jnp.float32) ** 2
                )
        else:
            def step(x_, w_):
                return jnp.sum(fn(x_, w_).astype(jnp.float32) ** 2)

        @jax.jit
        def chain(x_, w_, n):
            def body(_, carry):
                s, xx = carry
                s = s + step(xx, w_) * 1e-9
                # feed the scalar back into the carried tensor: without this
                # the loop body is loop-invariant and XLA hoists it (the
                # difference quotient then measures nothing)
                return s, xx * (1.0 + s * 1e-30).astype(xx.dtype)

            s, _ = lax.fori_loop(0, n, body, (jnp.float32(0), x_))
            return s

        float(chain(x_st, w, 1))

        def timed(n):
            t0 = time.perf_counter()
            float(chain(x_st, w, n))
            return time.perf_counter() - t0

        return timed

    # parity check before timing
    import numpy as np

    ref = np.asarray(sep8(x_st, w), np.float32)
    for name in ("fgrp8", "bgrp8", "block"):
        got = np.asarray(arms_fns[name](x_st, w), np.float32)
        rms = float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))
        assert rms < 0.05, f"{name} parity {rms}"
    print("parity ok", file=sys.stderr)

    timed = {name: (make_timed(fn), (4, 24)) for name, fn in arms_fns.items()}
    times = steady_state_times(timed, repeats=args.repeats)
    blk = times["block"]
    print(
        json.dumps(
            {
                "shape": {"b": b, "t": t, "f": f, "c": c, "grad": args.grad},
                **{
                    k: {"ms": round(v * 1e3, 3), "vs_block": round(blk / v, 3)}
                    for k, v in times.items()
                },
            }
        )
    )


if __name__ == "__main__":
    main()
