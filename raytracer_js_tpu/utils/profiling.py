"""Profiling and throughput observability.

The reference's only instrumentation is a wall-clock FPS HUD with a
32-sample simple moving average (/root/reference/src/main.ts:244-263) and a
static debug ray counter (raytracer.ts:77,98). This module provides the
accelerator-grade equivalents SURVEY.md §5 calls out as new work: rays/s meters,
an SMA matching the reference HUD's, and ``jax.profiler`` trace capture.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Iterator, Optional

import jax


class SMA:
    """Simple moving average over a fixed window (main.ts:244-252)."""

    def __init__(self, window: int = 32):
        self.buf = collections.deque(maxlen=window)

    def add(self, x: float) -> float:
        self.buf.append(float(x))
        return self.value

    @property
    def value(self) -> float:
        return sum(self.buf) / len(self.buf) if self.buf else 0.0


class RayMeter:
    """Counts rays and wall time across frames -> rays/s (the debug_ray_count
    analogue, made into an actual throughput meter)."""

    def __init__(self, sma_window: int = 32):
        self.total_rays = 0
        self.total_s = 0.0
        self.fps = SMA(sma_window)

    @contextlib.contextmanager
    def frame(self, n_rays: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.total_rays += n_rays
        self.total_s += dt
        self.fps.add(1.0 / dt if dt > 0 else 0.0)

    @property
    def rays_per_s(self) -> float:
        return self.total_rays / self.total_s if self.total_s else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``jax.profiler`` trace when ``logdir`` is set; no-op
    otherwise (so call sites can be unconditional)."""
    if not logdir:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


def block(x):
    """block_until_ready passthrough for timing hot paths."""
    return jax.block_until_ready(x)
