"""Test harness config: force an 8-device CPU mesh (SURVEY.md §4 test 6).

jax.config.update works here because no backend has been initialized yet.
Distributed (DP/TP/shard_map) logic is unit-tested on 8 fake CPU devices;
the GPU path is exercised by chip_smoke.py, and tests that need the card
carry the ``gpu`` marker (the `gpu_device` fixture skips them elsewhere).
"""

import os

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none (decided here, at
    run time, never while modules are imported)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; run on the card with `python -m pytest -m gpu`")
    return gpus[0]
