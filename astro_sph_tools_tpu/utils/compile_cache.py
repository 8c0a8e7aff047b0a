"""Where JAX keeps its persistent compilation cache.

Every entry point (the tests, ``bench.py``, ``chip_smoke.py`` and the
scripts in ``benchmarks/``) calls :func:`use_compile_cache` before its first
compile. The cache directory is part of the cache's key, so it is one fixed
path — never a temporary name, a process id or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache, listed in .gitignore
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and nothing
    is set here; otherwise the cache lives at :data:`DEFAULT_DIR`."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
