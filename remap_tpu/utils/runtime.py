"""Runtime configuration: JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

#: the cache's directory when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed path inside the checkout (listed in .gitignore), so every
#: process run from this checkout finds what an earlier one compiled
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def setup_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory
    itself and no other is set here.  Every program is cached, however
    small or quick to compile: the pipeline compiles many shapes once per
    process, and the cache is what makes a second run warm."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
