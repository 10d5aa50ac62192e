"""Process set-up shared by ``bench.py`` and ``chip_smoke.py``.

* :func:`enable_compile_cache` — where JAX keeps its persistent compilation
  cache: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself,
  nothing else is set), otherwise the fixed, git-ignored ``<repo>/.jax_cache``.
  The path is part of the cache key, so it never depends on a temporary
  name, a pid or the time.
* :func:`device_info` — the device a number was taken on, printed beside
  every measurement.
"""
from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO = pathlib.Path(__file__).resolve().parents[2]
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    path = str(REPO / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is no NVIDIA driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name
    and power limit."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "gpu": gpu_name_and_power()}
