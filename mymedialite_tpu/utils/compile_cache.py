"""Where the persistent XLA compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set this
module sets nothing. Otherwise the cache goes to a fixed directory in the
checkout: the path is part of the cache key, so a directory that moves
between runs never hits.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
