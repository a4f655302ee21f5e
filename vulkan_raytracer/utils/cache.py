"""Where JAX keeps its persistent compile cache.

Every entry point (CLI, bench, chip smoke, driver entry, tests) calls
:func:`setup_compile_cache` before its first compile.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing else
is set here; otherwise the cache lives in ``<checkout>/.jax_cache`` (a fixed
path, so later runs from the same checkout hit it).
"""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout's own cache directory (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Configure the persistent compile cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # keep every compile of a second or more: the traversal loops are
    # compile-heavy
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES" not in os.environ:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
