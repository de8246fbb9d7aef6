"""JAX runtime configuration helpers."""

from __future__ import annotations

import os
from pathlib import Path

# default persistent compile cache: a fixed directory inside the checkout
# (listed in .gitignore), so the cache key's path stays the same between
# runs of one checkout
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads that directory
    and nothing is set here; otherwise the cache goes to the checkout's
    own DEFAULT_CACHE_DIR."""
    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
