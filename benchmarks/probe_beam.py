#!/usr/bin/env python
"""Beam-decode throughput at the reference protocol width (W=100, V=62).

Times the jitted device prefix beam search on realistic logits shapes and
the native C++ host decoder on the same data; reports compile time and
utterances/s.

Usage: python benchmarks/probe_beam.py [--batch 16] [--t 256] [--w 100]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--v", type=int, default=62)
    ap.add_argument("--w", type=int, default=100)
    ap.add_argument("--max-len", type=int, default=80)
    ap.add_argument("--prune", type=float, default=-20.0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qasr.decode.beam import ctc_beam_search_decode
    from qasr.utils.profiling import steady_state_time

    logits = jax.random.normal(
        jax.random.PRNGKey(0), (args.batch, args.t, args.v)
    ) * 2.0
    lengths = jnp.full((args.batch,), args.t, jnp.int32)

    def decode(logits):
        return ctc_beam_search_decode(
            logits,
            lengths,
            beam_width=args.w,
            max_len=args.max_len,
            prune_logp=args.prune,
        )

    t0 = time.perf_counter()
    seq, lens, score = decode(logits)
    np.asarray(seq)  # sync
    compile_s = time.perf_counter() - t0

    # chain n decodes inside one jit (difference-quotient harness, bench.py)
    import functools

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(logits, n):
        def body(c, _):
            s, l, sc = decode(logits * (1.0 + c * 1e-20))
            return c + jnp.sum(sc) * 1e-20, ()

        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n)
        return c

    def run(n):
        float(chain(logits, n))
        t0 = time.perf_counter()
        float(chain(logits, n))
        return time.perf_counter() - t0

    dt = steady_state_time(run, n_small=2, n_big=8, repeats=args.repeats)
    device_utt_s = args.batch / dt

    # native host decoder on the same logits
    from qasr.native import ctc_beam_decode_native

    host_logits = np.asarray(logits, np.float32)
    host_lens = np.asarray(lengths)
    t0 = time.perf_counter()
    ctc_beam_decode_native(
        host_logits,
        host_lens,
        beam_width=args.w,
        max_len=args.max_len,
        prune_logp=args.prune,
    )
    host_dt = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "shape": f"B{args.batch} T{args.t} V{args.v} W{args.w}",
                "device_compile_s": round(compile_s, 1),
                "device_s_per_batch": round(dt, 4),
                "device_utt_per_s": round(device_utt_s, 1),
                "host_cpp_utt_per_s": round(args.batch / host_dt, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
