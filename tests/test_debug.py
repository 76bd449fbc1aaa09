"""Sanitizer / profiling-tier tests (SURVEY.md §5 "Race detection /
sanitizers"): the debug hooks must actually catch injected numerics faults
inside jit; trace() writes a profile; the device peak table knows only what
it lists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr.utils import debug, profiling


def test_nan_debug_catches_injected_nan():
    @jax.jit
    def f(x):
        return jnp.log(x)  # log(-1) -> NaN

    with debug.nan_debug():
        with pytest.raises(FloatingPointError):
            np.asarray(f(jnp.float32(-1.0)))
    # config restored: NaNs pass silently again outside the context
    assert np.isnan(np.asarray(f(jnp.float32(-1.0))))


def test_checkify_fn_surfaces_nan_as_error():
    def f(x):
        return jnp.sqrt(x) + 1.0

    checked = jax.jit(debug.checkify_fn(f))
    err, out = checked(jnp.float32(-4.0))
    with pytest.raises(Exception, match="nan"):
        err.throw()
    err_ok, out_ok = checked(jnp.float32(4.0))
    err_ok.throw()  # no error
    assert float(out_ok) == pytest.approx(3.0)


def test_checkify_fn_surfaces_oob_index():
    def f(x, i):
        return x[i]

    checked = jax.jit(debug.checkify_fn(f))
    err, _ = checked(jnp.arange(4.0), jnp.int32(7))
    with pytest.raises(Exception):
        err.throw()


def test_trace_writes_profile_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        float(jnp.sum(jnp.ones((8, 8)) @ jnp.ones((8, 8))))
    written = list(tmp_path.rglob("*.xplane.pb"))
    assert written and written[0].stat().st_size > 0


def test_device_peak_table_known_and_unknown_kinds():
    h100 = profiling.device_spec("NVIDIA H100 80GB HBM3")
    assert h100 is not None and h100.peak_bf16_tflops == 989.0 and h100.source
    # an unknown kind has no peak, so no roofline share is reported for it
    assert profiling.device_spec("cpu") is None
    assert profiling.device_spec("Some Future Accelerator") is None


def test_deterministic_mode_sets_partitionable():
    debug.deterministic_mode()
    assert jax.config.jax_threefry_partitionable
