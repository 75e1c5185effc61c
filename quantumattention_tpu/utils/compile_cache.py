"""Persistent XLA compilation cache for the repo's entry scripts."""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set: a
#: fixed path inside the checkout (listed in ``.gitignore``), so that the
#: path — part of the cache key — never moves between runs.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to :data:`DEFAULT_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
