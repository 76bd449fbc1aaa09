"""Tracing / profiling / roofline utilities (SURVEY.md §5).

The reference has no profiling beyond the Keras progress bar; here:

* `trace(...)` wraps `jax.profiler.trace` for TensorBoard/Perfetto dumps;
* `steady_state_time(...)` is the wall-clock harness: the difference quotient
  of two chained run lengths, which cancels fixed per-call costs (dispatch,
  the final host fetch) — each unit is one jit-compiled loop ending in a
  host fetch;
* `DEVICE_PEAKS` / `device_spec()` hold the published peaks of the devices
  the project is measured on, keyed by ``jax.Device.device_kind``;
* `conv_roofline(...)` reports the quaternion-conv achieved FLOPs against
  the device peak and against the 4x-expanded real conv.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_bf16_tflops: float  # dense, tensor cores
    hbm_gbps: float
    source: str


#: Published peaks by ``device_kind``. A device not listed has no peak: the
#: callers then report no roofline share rather than one against a guess.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "H100 SXM", 989.0, 3350.0,
        "NVIDIA H100 data sheet, SXM, dense bf16, at the 700 W power limit",
    ),
}


def device_spec(kind: str | None = None) -> DeviceSpec | None:
    """`DEVICE_PEAKS` entry for ``kind`` (default: the first JAX device's
    kind), or None for a device the table does not know."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    return DEVICE_PEAKS.get(kind)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into `log_dir` (TensorBoard / xprof format)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_events(trace_dir: str, *, lines: str = "Stream") -> list[tuple]:
    """``(start_ns, end_ns, name, stats)`` of the device-side events in the
    newest profile under ``trace_dir`` (written by `trace`), from the device
    lines whose name starts with ``lines`` (the GPU's kernel streams); where
    no line matches, all of the device's lines. A profile with no device
    plane (the CPU backend runs ops on host threads) yields its events that
    carry an ``hlo_op`` stat."""
    from pathlib import Path

    import jax

    files = sorted(Path(trace_dir).rglob("*.xplane.pb"), key=lambda f: f.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir!r}")
    planes = list(jax.profiler.ProfileData.from_file(str(files[-1])).planes)
    devices = [p for p in planes if p.name.startswith("/device:")]
    out = []
    for plane in devices or planes:
        plane_lines = list(plane.lines)
        chosen = [ln for ln in plane_lines if ln.name.startswith(lines)] or plane_lines
        for ln in chosen:
            for ev in ln.events:
                stats = dict(ev.stats)
                if devices or "hlo_op" in stats:
                    start = int(ev.start_ns)
                    out.append((start, start + int(ev.duration_ns), ev.name, stats))
    return out


def busy_ns(events) -> int:
    """Length of the union of the events' intervals (device busy time)."""
    total, end = 0, None
    for s, e, *_ in sorted(events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def steady_state_times(runs: dict, *, n_small=5, n_big=25, repeats=3) -> dict:
    """Interleaved difference-quotient seconds/step for several arms.

    ``runs`` maps name -> run_chained(n) -> wall seconds, or name ->
    (run_chained, (n_small, n_big)) for per-arm chain lengths. Arms are
    interleaved ABAB across repeats (shed drift) and per-arm
    medians are returned. This is the project's one timing harness —
    bench.py and the benchmarks/ probes all route through it.
    """
    import statistics

    norm = {
        k: (v if isinstance(v, tuple) else (v, (n_small, n_big)))
        for k, v in runs.items()
    }
    est = {k: [] for k in runs}
    for _ in range(repeats):
        for name, (run, (ns, nb)) in norm.items():
            t_small = run(ns)
            t_big = run(nb)
            est[name].append((t_big - t_small) / (nb - ns))
    return {k: statistics.median(v) for k, v in est.items()}


def steady_state_time(run_chained, *, n_small=5, n_big=25, repeats=3) -> float:
    """Difference-quotient seconds/step for `run_chained(n) -> wall seconds`."""
    return steady_state_times(
        {"arm": run_chained}, n_small=n_small, n_big=n_big, repeats=repeats
    )["arm"]


def qconv_flops(batch, t, f, cin, cout, kh=3, kw=3) -> int:
    """FLOPs of one quaternion conv fwd at SAME padding (16 block
    products == the 4x-expanded real conv's FLOPs; the reference's strategy,
    SURVEY.md §3.2)."""
    return 2 * batch * t * f * kh * kw * (4 * cin) * (4 * cout)


def conv_roofline(
    *,
    batch=16,
    t=256,
    f=13,
    cin=64,
    cout=64,
    dtype="bfloat16",
    variant="block",
    repeats=3,
) -> dict:
    """Measure achieved quaternion-conv FLOPs vs the device's peak.

    Returns a dict with achieved TFLOP/s, % of peak, and seconds/step for the
    quaternion path and the explicitly 4x-expanded real conv baseline.
    `variant` picks the Hamilton path (block | fast | fast10); FLOPs are
    always counted as the 16-product equivalent (the reference's per-step
    computation), so the 10-product path can legitimately exceed 100 % of
    the *expanded-conv* roofline — that is the algorithmic win. The share
    of peak is None on a device `DEVICE_PEAKS` does not know.
    """
    import jax
    import jax.numpy as jnp

    from qasr.ops.qlinalg import qconv, qconv_fast, qconv_fast10
    from qasr.ops.quaternion import hamilton_expand

    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kx, kw_ = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(kx, (batch, t, f, 4 * cin), dt)
    w = jax.random.normal(kw_, (4, 3, 3, cin, cout), dt)
    w_big = hamilton_expand(w)

    paths = {"block": qconv, "fast": qconv_fast, "fast10": qconv_fast10}
    q_fn = jax.jit(paths[variant])

    @jax.jit
    def real_fn(x, w_big):
        from jax import lax

        dn = lax.conv_dimension_numbers(
            x.shape, w_big.shape, ("NHWC", "HWIO", "NHWC")
        )
        return lax.conv_general_dilated(x, w_big, (1, 1), "SAME", dimension_numbers=dn)

    import functools

    def make_chain(fn, *args):
        # ONE jit-compiled scan of n chained convs ending in a scalar the
        # host fetches; RMS-normalize between convs so bf16 values stay
        # finite along the chain.
        @functools.partial(jax.jit, static_argnames=("n",))
        def chain(x, n, *rest):
            def body(c, _):
                y = fn(c, *rest)
                scale = jax.lax.rsqrt(
                    jnp.mean(y.astype(jnp.float32) ** 2) + 1e-6
                ).astype(y.dtype)
                return y * scale, ()

            out, _ = jax.lax.scan(body, x, None, length=n)
            return jnp.sum(out.astype(jnp.float32))

        def run(n):
            float(chain(args[0], n, *args[1:]))  # warm/compile
            t0 = time.perf_counter()
            v = float(chain(args[0], n, *args[1:]))
            dt_run = time.perf_counter() - t0
            assert v == v, "non-finite chain output"
            return dt_run

        return run

    # chainable only if shapes match (SAME padding, cin == cout)
    assert cin == cout, "roofline harness chains outputs; needs cin == cout"
    t_q = steady_state_time(
        make_chain(lambda c, ww: q_fn(c, ww), x, w),
        n_small=10, n_big=60, repeats=repeats,
    )
    t_r = steady_state_time(
        make_chain(lambda c, ww: real_fn(c, ww), x, w_big.astype(dt)),
        n_small=10, n_big=60, repeats=repeats,
    )

    flops = qconv_flops(batch, t, f, cin, cout)
    spec = device_spec()
    achieved_q = flops / t_q / 1e12
    achieved_r = flops / t_r / 1e12
    return {
        "flops_per_step": flops,
        "qconv_s": t_q,
        "expanded_real_s": t_r,
        "qconv_tflops": achieved_q,
        "expanded_real_tflops": achieved_r,
        "qconv_pct_of_peak": (
            100 * achieved_q / spec.peak_bf16_tflops if spec else None
        ),
        "qconv_vs_expanded_real": t_r / t_q,
        "variant": variant,
        "device_kind": jax.devices()[0].device_kind,
    }
