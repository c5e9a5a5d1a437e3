"""Persistent compile cache location: JAX_COMPILATION_CACHE_DIR wins when
set; otherwise the cache lives in <checkout>/.jax_cache."""

from pathlib import Path

import jax

from tinyslam.utils import cache


def test_env_var_is_honoured(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    target = str(tmp_path / "xla_cache")
    jax.config.update("jax_compilation_cache_dir", target)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    try:
        assert cache.enable_compilation_cache() == target
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_is_in_the_checkout(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = Path(__file__).resolve().parents[1]
    try:
        got = cache.enable_compilation_cache()
        assert Path(got) == checkout / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == got
        assert Path(got).is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
