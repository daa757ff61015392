"""Persistent XLA compilation cache at one fixed place.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX reads it and no
other directory is set here. Otherwise the cache lives in `.jax_cache/` at
the repository root (listed in .gitignore): a fixed path, so repeated runs
from one checkout hit it.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
