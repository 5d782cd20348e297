"""Persistent XLA compilation cache location — one rule for every entry
point (bench, chip smoke test, graft entry, test suite)."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(root: str) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<root>/.jax_cache``
    (a fixed path inside the checkout, listed in ``.gitignore``: the path
    is part of the cache key, so a directory that moves never hits)."""
    return os.environ.get(ENV_VAR) or os.path.join(
        os.path.abspath(root), ".jax_cache"
    )


def enable_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at ``cache_dir(root)`` and
    return the directory.  Programs that compile in under half a second
    are not worth a cache entry."""
    import jax

    path = cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
