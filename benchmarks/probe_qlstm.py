#!/usr/bin/env python
"""The QLSTM recurrence on the card: time and trace the fused rank-8 scan.

At librispeech_qlstm's shapes (H=256, T=512, bf16):

1. the recurrence alone (`qasr.models.qlstm.lstm_recurrence`: both
   directions in one `lax.scan`), forward+backward, at --b (default 8) and
   at the preset batch 32: ms per call on the host clock around
   `block_until_ready`, once with the recurrent weights entering the scan in
   float32 (the default: their gradient is summed in float32) and once in
   bfloat16, in the order f32, bf16, bf16, f32; then, from a profiler trace
   of the float32 version, the device busy time per call and per scan step
   and the kernels per scan step. The device's idle time per call is the
   host-clock time less the busy time: the traced window is longer than an
   untraced call, because the profiler slows the launches it records;
2. the whole librispeech_qlstm train step at the preset batch and T: ms per
   step, and from its trace the device time of the kernels under the
   ``qlstm_recurrence`` scope: the recurrence's share of the step.

    python benchmarks/probe_qlstm.py [--trace-dir .smoke_work/qlstm_trace]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPE = "qlstm_recurrence"


def timed(fn, *args, n=10):
    """Mean ms per call over n calls after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def traced(fn, args, trace_dir, n=3):
    """Device events of n calls of fn under the profiler."""
    import jax

    from qasr.utils.profiling import device_events, trace

    jax.block_until_ready(fn(*args))
    with trace(trace_dir):
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
    return device_events(trace_dir)


def op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> its op_name metadata (the jax name stack),
    from a compiled program's text."""
    import re

    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')
    return {m.group(1): m.group(2) for m in map(pat.match, hlo_text.splitlines()) if m}


def in_scope(ev, names: dict[str, str]) -> bool:
    stats = ev[3]
    return SCOPE in names.get(str(stats.get("hlo_op", "")), "") or any(
        isinstance(v, str) and SCOPE in v for v in stats.values()
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--trace-dir", default=".smoke_work/qlstm_trace")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from qasr.configs import get_config
    from qasr.models.qlstm import lstm_recurrence
    from qasr.utils.profiling import busy_ns

    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    t, h = args.t, args.h
    dtype = jnp.bfloat16
    rng = np.random.RandomState(0)

    def recurrence_fwd_bwd(b, weight_dtype):
        z = jnp.asarray(rng.randn(2, b, t, 16 * h), dtype)
        wh = jnp.asarray(rng.randn(2, 4, h, 4 * h) * 0.02, jnp.float32)
        lengths = jnp.full((b,), t, jnp.int32)

        def loss(z_, wh_):
            hs = lstm_recurrence(z_, wh_, lengths, reverse=(False, True), dtype=dtype,
                                 weight_dtype=weight_dtype)
            return jnp.sum(hs.astype(jnp.float32) ** 2)

        return jax.jit(jax.grad(loss, argnums=(0, 1))), (z, wh)

    results = {}
    for b in sorted({args.b, 32}):
        fns = {wd: recurrence_fwd_bwd(b, wd) for wd in (jnp.float32, jnp.bfloat16)}
        ms = {wd: [] for wd in fns}
        for wd in (jnp.float32, jnp.bfloat16, jnp.bfloat16, jnp.float32):
            fn, fargs = fns[wd]
            ms[wd].append(timed(fn, *fargs, n=20))
        ms = {wd: sum(v) / len(v) for wd, v in ms.items()}
        f32_ms, bf16_ms = ms[jnp.float32], ms[jnp.bfloat16]
        results[b] = f32_ms
        print(
            f"recurrence B{b} T{t} H{h} fwd+bwd, host clock: weights in f32 "
            f"{f32_ms:.3f} ms/call, in bf16 {bf16_ms:.3f} ms/call "
            f"(f32/bf16 {f32_ms / bf16_ms:.4f})",
            flush=True,
        )
        fn, fargs = fns[jnp.float32]
        n = 3
        ev = traced(fn, fargs, os.path.join(args.trace_dir, f"recurrence_b{b}"), n=n)
        window = max(e for _, e, *_ in ev) - min(s for s, *_ in ev)
        busy_ms = busy_ns(ev) / 1e6 / n
        steps = 2 * t  # forward scan + its transpose, T steps each
        print(
            f"  trace (weights in f32): {len(ev) / n / steps:.2f} kernels per scan step; "
            f"busy {busy_ms:.3f} ms/call = {busy_ms / steps * 1e3:.2f} us per scan step; "
            f"idle (host clock less busy) {f32_ms - busy_ms:.3f} ms/call = "
            f"{(f32_ms - busy_ms) / steps * 1e3:.2f} us per scan step; traced window "
            f"{window / 1e6 / n:.3f} ms/call (profiler overhead included)",
            flush=True,
        )
        names = {}
        for s_, e_, name, _ in ev:
            names[name] = names.get(name, 0) + (e_ - s_)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        print("  top kernels: " + "; ".join(f"{k[:60]} {v / 1e6 / n:.3f} ms" for k, v in top))

    # the whole train step at the preset batch and T=512
    from bench import _make_batch
    from qasr.train.state import create_train_state
    from qasr.train.step import make_train_step

    cfg = get_config("librispeech_qlstm")
    bsz = cfg.data.batch_size
    batch = _make_batch(bsz, t, cfg.data.n_mels, cfg.model.vocab, 64)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = create_train_state(cfg, jax.random.PRNGKey(0), batch["features"])
    step = make_train_step(cfg)

    names = op_names(step.lower(state, batch).compile().as_text())

    def run(state, batch):
        return step(state, batch)

    state, m = run(state, batch)
    jax.block_until_ready(state)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = run(state, batch)
    jax.block_until_ready(state)
    step_ms = (time.perf_counter() - t0) / n * 1e3
    trace_dir = os.path.join(args.trace_dir, "train_step")
    from qasr.utils.profiling import device_events, trace

    with trace(trace_dir):
        for _ in range(3):
            state, m = run(state, batch)
        jax.block_until_ready(state)
    ev = device_events(trace_dir)
    busy = busy_ns(ev)
    window = max(e for _, e, *_ in ev) - min(s for s, *_ in ev)
    scoped = [e for e in ev if in_scope(e, names)]
    rec = busy_ns(scoped)
    print(
        f"librispeech_qlstm train step B{bsz} T{t}: {step_ms:.3f} ms/step (host "
        f"clock) | trace: busy {busy / 3e6:.3f} ms/step, idle share (host clock) "
        f"{1 - busy / 3e6 / step_ms:.4f}, traced window {window / 3e6:.3f} ms/step | "
        f"under '{SCOPE}': {rec / 3e6:.3f} ms/step = {rec / busy:.3f} of device "
        f"busy ({len(scoped)} of {len(ev)} kernels)",
        flush=True,
    )
    layers = cfg.model.lstm_layers
    print(
        f"estimate from the isolated recurrence: {layers} layers x "
        f"{results[32]:.3f} ms = {layers * results[32]:.3f} ms = "
        f"{layers * results[32] / step_ms:.3f} of the step",
        flush=True,
    )


if __name__ == "__main__":
    main()
