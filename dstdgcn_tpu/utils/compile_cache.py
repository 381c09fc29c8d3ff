"""Persistent XLA compilation cache location.

One rule for every entry point (``main.py``, ``bench.py``,
``chip_smoke.py``): when ``JAX_COMPILATION_CACHE_DIR`` is set JAX already
reads it and nothing else is configured here; otherwise the cache lives at
a fixed directory inside the checkout, ``.jax_cache/``.  The path is part
of the cache key, so it never depends on a temporary name, a process id
or the time.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The directory the compile cache uses under ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir`."""
    path = cache_dir()
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
