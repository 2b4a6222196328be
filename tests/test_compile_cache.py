"""The compile-cache helper every entry point calls."""

import os

import jax
import pytest

from ccs_tpu.compile_cache import (CHECKOUT, compile_cache_dir,
                                   configure_compile_cache)


@pytest.mark.parametrize("env", [None, "custom"])
def test_configure_compile_cache(env, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache.
    The choice lands in jax.config, not only in the environment."""
    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(CHECKOUT, ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert compile_cache_dir() == want
        assert configure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
