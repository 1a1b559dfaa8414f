"""Where XLA's persistent compile cache lives.

A process that compiles the same programs as an earlier one (a second
benchmark run, a restarted server) reads them back instead of compiling.
The cache key includes the directory, so the directory must not move
between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is set
(JAX reads the variable itself, and nothing else is changed), and the
fixed ``<repo>/.jax_cache`` otherwise.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; call before
    the first compile. Returns the directory used."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
