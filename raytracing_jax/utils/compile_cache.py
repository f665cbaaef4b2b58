"""JAX's persistent compilation cache, in one fixed place.

`JAX_COMPILATION_CACHE_DIR` wins when it is set (JAX reads it itself);
otherwise the cache goes to `<repo>/.jax_cache`. The path is part of a
cache entry's key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
