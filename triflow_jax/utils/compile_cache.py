"""Persistent XLA compilation cache for the repository's scripts.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing here changes it.  Otherwise the cache lives at one fixed
path inside the checkout, ``<repo>/.jax_cache`` (listed in .gitignore), so
that reruns on the same machine find their compiled programs again.
"""

import os
from pathlib import Path

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Switch the persistent cache on; returns the directory in use."""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
