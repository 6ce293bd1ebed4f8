"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLIs, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py`` and the scripts) calls :func:`enable_compile_cache`
before its first compile, so all of them share one cache: the directory named
by ``JAX_COMPILATION_CACHE_DIR`` when that is set, else ``<repo>/.jax_cache``.
The path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or the default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that path."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
