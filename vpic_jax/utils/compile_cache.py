"""Persistent XLA compilation cache for the command-line entry points.

JAX keys cached executables partly by the cache directory, so the directory
must not move between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, else the fixed ``.jax_cache`` at the root of the checkout.  Library
import never calls this; scripts and the CLI call it before their first
compile.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
