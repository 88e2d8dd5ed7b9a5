"""Persistent XLA compilation cache.

The cache lives where $JAX_COMPILATION_CACHE_DIR says when it is set, and
otherwise in one fixed directory inside the checkout (`.jax_cache/`,
listed in .gitignore) — a fixed path, because the path is part of the
cache key. Call early (before the first jit executes)."""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The compile-cache directory this checkout uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable_compilation_cache() -> None:
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
