"""Persistent XLA compile cache location, shared by bench.py and
chip_smoke.py.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
is set here. Otherwise the cache goes to one fixed path inside the
checkout (`.jax_cache/`, git-ignored): the path is part of the cache
key, so a directory that moves never hits."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
