"""Compile-cache placement and timing helpers (``utils.perf``)."""

import os

import jax
import jax.numpy as jnp
import pytest

from shot_fpfh_tpu.utils import perf


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_uses_the_environment_directory(
        monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert perf.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; the program sets no directory of its own
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_the_checkout(monkeypatch,
                                                restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(perf.__file__)))
    expected = os.path.join(os.path.dirname(root), ".jax_cache")
    assert perf.compilation_cache_dir() == expected
    assert perf.enable_compilation_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected


def test_timeit_returns_the_ready_pytree():
    timed = perf.timeit(lambda: {"a": jnp.arange(3), "b": (jnp.ones(2), None)})
    out = timed()
    assert out["a"].tolist() == [0, 1, 2] and out["b"][1] is None
