"""The compile-cache rule (sdrangel_tpu/compile_cache.py): with
JAX_COMPILATION_CACHE_DIR set nothing is set in code; without it the cache
is <checkout>/.jax_cache."""

import os

import jax
import pytest

from sdrangel_tpu import compile_cache


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_set_sets_nothing(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() is None
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_env_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert compile_cache.configure() == want
    assert jax.config.jax_compilation_cache_dir == want
