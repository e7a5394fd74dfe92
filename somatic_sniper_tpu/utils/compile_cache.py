"""Persistent XLA compilation cache for the device (fast) path.

The fast path compiles a tiny, stable set of shapes (one slab shape per
run), so JAX's persistent compilation cache turns every run after the
first into a warm start — per machine, across processes.

Enabled by the CLI and by ``runner.get_device_tables`` (i.e., before the
first device dispatch).  Resolution:

- a cache directory JAX already has — from ``JAX_COMPILATION_CACHE_DIR``,
  which JAX reads itself, or set by the caller — is left alone;
- otherwise the cache lives at ``<repo root>/.jax_cache`` (git-ignored).
  The path is fixed because it is part of the cache key.
"""

from __future__ import annotations

from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def enable_persistent_cache() -> None:
    """Idempotently point JAX at a persistent compilation cache dir."""
    global _done
    if _done:
        return
    _done = True
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    try:
        DEFAULT_DIR.mkdir(exist_ok=True)
    except OSError:
        return  # read-only install: run without a persistent cache
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
