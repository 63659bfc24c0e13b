"""Where JAX keeps its persistent compilation cache.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache goes to a fixed directory inside the
checkout (listed in .gitignore): the directory is part of the cache key,
so it never contains a temporary name, a process id or a time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's compilation cache at its place; returns the directory."""
    import jax

    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
