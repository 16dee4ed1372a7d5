"""Process set-up shared by the entry points: the persistent compile cache
and the accelerator gate.

Every entry point (bench.py, chip_smoke.py, train/run.py, server/api.py,
__graft_entry__.py) calls `enable_compile_cache()` before its first compile.
Measurement entry points call `require_gpu()`: a run that finds no GPU
fails rather than reporting a CPU number under a device metric's name.
"""

from __future__ import annotations

import os
import sys

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# fixed, git-ignored: the cache key includes the path, so it must not move
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    Takes effect only before the process's first compile (JAX decides once
    whether the cache is in use). Returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """The device every printed result is attributed to."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """Exit with code 2 unless JAX's default backend is a GPU. Never falls
    back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        print(f"error: no GPU found (jax default platform is "
              f"{info['platform']!r}); refusing to run", file=sys.stderr,
              flush=True)
        sys.exit(2)
    return info
