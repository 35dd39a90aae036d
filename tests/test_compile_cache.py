"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise one fixed directory inside the checkout."""

import os

import jax

from libzseek_jax.utils import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.enable_compile_cache() == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == cc.CACHE_DIR
    # the same path on every call: no pid, time or temporary name in it
    assert cc.enable_compile_cache() == cc.CACHE_DIR


def test_default_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
