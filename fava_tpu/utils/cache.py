"""Persistent XLA compilation cache: one rule for every entry point.

The big fused analysis programs (e.g. the 512^3 flagship step) take
seconds to compile; cache hits load in well under a second. Call
:func:`enable_compilation_cache` once per process (``chip_smoke.py``,
``bench.py`` and the pipeline CLI do).
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: a fixed path (the cache key includes it), which
# .gitignore lists.
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> Path:
    """Return the persistent cache directory in use, enabling it if needed.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this function sets nothing. Otherwise the cache is
    ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    import jax

    CHECKOUT_CACHE.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return CHECKOUT_CACHE
