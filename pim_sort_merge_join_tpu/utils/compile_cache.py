"""Where the persistent XLA compilation cache lives.

Compiling the 10M-row pipeline takes tens of seconds; a persistent cache
lets later processes reuse the executables. The cache key includes the
directory path, so the directory must not move between runs: it is either
what ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads that variable itself) or
the fixed ``<repo>/.jax_cache``, never a temporary or per-process path.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory to configure, or None when the environment names one."""
    if environ.get(ENV_VAR):
        return None
    return str(REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``.

    With ``JAX_COMPILATION_CACHE_DIR`` set this leaves JAX's own setting
    untouched, so the cache is written only where the variable says.
    """
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
