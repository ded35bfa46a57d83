"""Persistent XLA compilation cache at one fixed place.

A full alignment step takes tens of seconds to compile on the GPU, and
every new process would pay it again.  JAX keys its persistent cache by
program and directory, so the directory must not move between runs: a
temporary name, a pid or a time stamp would never hit.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache (git-ignored)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache goes to ``DEFAULT_CACHE_DIR``.  Call
    before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
