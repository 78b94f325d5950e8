"""Persistent XLA compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module leaves it alone. Otherwise the cache lives at one fixed path inside
the checkout, ``<repo>/.jax_cache`` (git-ignored): the path is part of the
cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the checkout's."""
    return os.environ.get(ENV) or os.path.join(_REPO, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on (before the first compile) and return
    its directory."""
    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
