"""The compilation-cache helper (utils/compile_cache.py)."""

import os

import jax

from raytracing_jax.utils import compile_cache


def _restore(before):
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        _restore(before)


def test_default_is_the_repository_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable()
    finally:
        _restore(before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert path == compile_cache.REPO_CACHE
