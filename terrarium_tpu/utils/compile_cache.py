"""Placement of JAX's persistent compilation cache.

One rule for every entry point (``chip_smoke.py``, ``bench*.py``,
``experiments/run_year.py``): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here; otherwise the cache lives at
``<checkout>/.jax_cache``, derived from this file's location. The path is
part of the cache key, so it never contains a temporary name, a process id
or a time.
"""
from __future__ import annotations

import os
import pathlib

__all__ = ["ENV_VAR", "default_cache_dir", "configure_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> pathlib.Path:
    """``<checkout>/.jax_cache`` (listed in ``.gitignore``)."""
    return pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
