"""Process-level JAX setup for the CLIs/services.

Enables the persistent compilation cache: the fused extraction program
costs tens of seconds to compile per geometry, which dominates short CLI
runs; with the cache, repeat invocations (the common production pattern:
same clip geometry every video) start hot.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (JAX reads
that variable itself, so this module then sets nothing), otherwise a fixed
directory inside the checkout, `<repo>/.jax_cache` (listed in .gitignore).
A fixed path matters: the path is part of the cache's key, so a directory
that moves never hits.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_jax() -> str:
    """Enable the persistent compilation cache (idempotent, best-effort).
    Returns the cache directory in use. Without JAX_COMPILATION_CACHE_DIR
    the repo directory is exported under that name before jax is imported
    (so jax configures it exactly as it would a preset variable, and child
    processes share it) and set on jax's live config in case jax was
    imported earlier."""
    preset = bool(os.environ.get(CACHE_ENV))
    path = os.environ[CACHE_ENV] if preset else REPO_CACHE_DIR
    if not preset:
        os.environ[CACHE_ENV] = path
    import jax

    try:
        if not preset:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception as exc:  # never fail a service for cache trouble
        log.warning("could not enable jax compilation cache: %s", exc)
    return path
