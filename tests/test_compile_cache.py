"""The compile-cache helper: the environment variable wins; otherwise one
fixed directory inside the checkout."""

from pathlib import Path

import jax
import pytest

from qasr.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_respected(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache") == str(compile_cache.DEFAULT_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
