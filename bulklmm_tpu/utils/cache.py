"""Persistent XLA compilation cache for the entry points.

A cold process recompiles every scan core, which takes tens of seconds.
The entry points (``cli.main``, ``bench.py``, ``chip_smoke.py``,
``benchmarks/*.py``) call :func:`use_compile_cache` before their first
compile so a second run loads the executables instead. The library itself
sets nothing: importing it never changes a caller's JAX configuration.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: the checkout's fixed cache directory (listed in .gitignore). A fixed
#: path matters: it is part of the cache key, so a per-run name never hits.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``DEFAULT_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads that itself, and
    this sets nothing). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
