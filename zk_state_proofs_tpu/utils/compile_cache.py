"""Persistent XLA compile cache for the program's entry points."""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at $JAX_COMPILATION_CACHE_DIR
    when it is set, and at <checkout>/.jax_cache otherwise. Set through
    jax.config, since JAX reads the variable only when it is imported.
    Returns the directory."""
    path = os.environ.get(ENV) or str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
