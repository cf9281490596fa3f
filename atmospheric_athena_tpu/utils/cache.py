"""Persistent XLA compilation cache location.

The production step takes tens of seconds to compile at full size, so every
entry point (the CLI, ``bench.py``, ``chip_smoke.py``, the tests and the
tools) keeps compiled programs across processes.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: fixed, derived from this file's location (the path
# is part of the cache key, so it must not move between runs)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache goes to
    ``<checkout>/.jax_cache``."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
