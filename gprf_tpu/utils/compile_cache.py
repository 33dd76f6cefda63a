"""Where the persistent XLA compile cache lives, one rule for every entry
point.

Compiling the fused objective takes seconds to minutes, and every CLI run
is a fresh process, so the entry points share JAX's persistent compile
cache.  The cache's path is part of its key: a directory that moves never
hits, so the default is a fixed directory inside the checkout.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def configure_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at ``<repo>/.jax_cache``.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Returns the directory this call set, or None.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
