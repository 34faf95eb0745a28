"""Persistent XLA compilation cache.

JAX's persistent compilation cache stores each compiled executable keyed
by its HLO hash, so a repeat compile — across processes — becomes a file
load.  The cache path is part of how a later process finds an entry
again, so it is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the
environment sets it (JAX reads that variable itself), otherwise
``<repo>/.jax_cache``.

Not enabled at package import (a library should not write to disk by
default); ``chip_smoke.py``, ``bench.py`` and ``bench_all.py`` call
:func:`enable_compile_cache`, and users can opt in the same way.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: ``JAX_COMPILATION_CACHE_DIR`` if set (no other directory
    is set in code then), else :data:`REPO_CACHE_DIR`.  Call before the
    first compile to catch everything."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # trivial programs are faster to recompile than to hash+load
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
