"""The one place that chooses JAX's persistent compilation cache directory.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py`` and the tests) calls :func:`configure_compile_cache`
before its first compile. The directory is ``$JAX_COMPILATION_CACHE_DIR``
when that is set, and otherwise ``<checkout>/.jax_cache`` (listed in
``.gitignore``): a fixed path, because the path is part of the cache key.
The choice goes through ``jax.config.update``; an environment variable set
after ``import jax`` is never read.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The cache directory the helper would configure."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
