"""Numerics debugging / sanitizer hooks (SURVEY.md §5 "Race detection").

The reference has nothing here (single device, Python). In JAX the
equivalents are: NaN trapping via `jax.debug_nans`, functional error checking
via `jax.experimental.checkify` (NaN/OOB/div-by-zero inside jit), and
deterministic-reduction settings for bitwise-reproducible tests. Collective
deadlocks are avoided by construction — SPMD via GSPMD only, no ad-hoc
point-to-point.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def nan_debug():
    """Raise on any NaN produced inside jit (slow; debugging only)."""
    import jax

    # contextmanager-backed flags must be read as attributes, not via
    # config.read() (jax raises AttributeError for those)
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def checkify_fn(fn, *, errors=None):
    """Wrap `fn` with checkify so float/index errors surface as values.

    Returns wrapped(fn) -> (error, out); call `error.throw()` host-side.
    """
    from jax.experimental import checkify

    if errors is None:
        errors = checkify.float_checks | checkify.index_checks
    return checkify.checkify(fn, errors=errors)


def deterministic_mode():
    """Settings for bitwise-reproducible CI runs."""
    import jax

    jax.config.update("jax_threefry_partitionable", True)
    return {"xla_flags": "--xla_gpu_deterministic_ops=true"}
