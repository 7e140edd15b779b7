"""Placement of JAX's persistent compilation cache.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no other directory. Otherwise the cache lives at one fixed path inside
the checkout, `<repo>/.jax_cache` (listed in .gitignore): the directory is
part of the cache key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at REPO_CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR is set, which JAX reads itself. Call before
    the first compile; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
