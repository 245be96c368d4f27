"""configure_compile_cache: one fixed cache directory per checkout."""

import os

import jax

from active_orb_slam2_tpu.utils.runtime import (
    REPO_CACHE_DIR, configure_compile_cache)


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert configure_compile_cache() == str(tmp_path)
        # nothing was set over the environment's choice
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        _restore(prev)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert configure_compile_cache() == REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")
    finally:
        _restore(prev)
