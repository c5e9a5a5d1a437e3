"""Persistent XLA compilation cache.

A cold compile of the full tracked step (a large scan-of-cond HLO) takes
tens of seconds; the persistent cache lets every later process with the
same programs skip it.  Called by the CLI entry points (run.py, bench.py,
chip_smoke.py, tools/eval_ate.py); library users opt in explicitly.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: a fixed path, because the cache directory is part of
# what makes a cached entry findable again.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns the cache dir.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
    alone.  Otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_CACHE_DIR)
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
