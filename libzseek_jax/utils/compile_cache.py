"""Where JAX keeps its persistent compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives in one fixed directory of
the checkout, <repo>/.jax_cache (listed in .gitignore): the path is part
of the cache's key, so a directory named after a pid, a time or a
temporary name would never hit.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
