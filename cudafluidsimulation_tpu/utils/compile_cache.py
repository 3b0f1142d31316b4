"""JAX's persistent compilation cache, shared by the CLI, bench.py and
chip_smoke.py."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path, because the cache directory is part of
# the cache key — a per-run or per-user directory would never be hit again.
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache and return its directory: the one
    ``JAX_COMPILATION_CACHE_DIR`` names when it is set (JAX reads that
    variable itself, so nothing is set here), else :data:`DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
