"""Process set-up for scripts that drive the library (never run at import)."""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; call before the first
    compile. ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX, which
    reads it itself; otherwise the cache lives in the checkout's
    ``.jax_cache`` (a fixed path, ignored by git). Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
