"""The persistent compile-cache helper the scripts and the CLI call."""

import os

import jax
import pytest

from vpic_jax.utils import compile_cache as CC


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_enable_compile_cache(env_dir, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at the fixed .jax_cache in the checkout, the same path every run."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expect = CC.DEFAULT_DIR
    else:
        expect = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expect)
    try:
        assert CC.enable_compile_cache() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert CC.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
