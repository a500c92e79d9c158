"""Persistent XLA compilation cache, shared by every entry point.

The session, the CLI, `bench.py`, `chip_smoke.py` and the tests all call
`enable_persistent_cache()`. If `JAX_COMPILATION_CACHE_DIR` is set, JAX
already reads it and the cache stays there; otherwise the cache goes to the
fixed path `<checkout>/.jax_cache`. A fixed path matters: the directory is
part of the cache key, so a cache that moves never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's compilation cache at `cache_dir()` (idempotent) and cache
    every entry, however small or quick to compile. Returns the directory."""
    import jax

    path = cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
