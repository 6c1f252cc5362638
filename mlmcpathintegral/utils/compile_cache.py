"""Persistent XLA compilation cache shared by the entry points.

MLMC set-up compiles ~150 small programs (per-level prepare, burn-in and
chunk kernels at each t_sub), so a warm cache removes most of a repeated
run's set-up time.
"""

from __future__ import annotations

import os
from pathlib import Path

#: used when JAX_COMPILATION_CACHE_DIR is not set (listed in .gitignore)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory
    itself and no directory is set here; otherwise the cache lives at the
    fixed ``DEFAULT_DIR`` (a fixed path, so one run finds the next one's
    entries).  The minimum compile time for an entry is lowered from 1 s
    so the many sub-second MLMC programs are kept too."""
    import jax
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.05)
    return cache_dir
