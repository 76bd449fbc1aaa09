"""JAX's persistent compilation cache, configured in one place.

Every entry point (the training CLI, bench.py, chip_smoke.py, the scripts
under benchmarks/ and tools/) calls `enable_compile_cache()` before its first
compile, so reruns skip XLA compiles they have done before.
"""

from __future__ import annotations

import os
from pathlib import Path

#: The default cache: a fixed directory inside the checkout (listed in
#: .gitignore). The path is part of the cache key, so it must not move.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to `DEFAULT_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
