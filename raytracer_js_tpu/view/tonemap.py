"""Tone mapping — dynamic-range window selection.

Re-design of the reference ToneMapper hierarchy
(/root/reference/src/view/tone_mapping.ts:21-79): the virtual
``get_dynamic_range(ebuffer)`` dispatch becomes a pure function of the
buffer statistics selected by a static enum; the two full-buffer scalar
scans (mean, then deviation) are two jnp reductions XLA fuses.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import ToneMapConfig, ToneMapperKind
from . import exposure as ex

Array = jnp.ndarray


def dynamic_range(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> Tuple[Array, Array]:
    """(drange_low, drange_high) for the display window.

    * IDENTITY — fixed [0, 1] (tone_mapping.ts:25-33);
    * DR_LIMITED — statistics-free fixed window [min_dynamic,
      min_dynamic * 2^k] (tone_mapping.ts:35-46);
    * STDDEV_AROUND_MEAN — hi = min(mean + std, max_dynamic), lo = hi/2^k,
      floored at min_dynamic with hi re-derived (tone_mapping.ts:48-63);
    * ABSDEV_AROUND_MEAN — same with mean absolute deviation
      (tone_mapping.ts:65-79).
    """
    if cfg.kind == ToneMapperKind.IDENTITY:
        z = jnp.zeros((), jnp.float32)
        return z, z + 1.0
    if cfg.kind == ToneMapperKind.DR_LIMITED:
        coef = float(1 << cfg.dynamic_range)
        lo = jnp.asarray(cfg.min_dynamic, jnp.float32)
        return lo, lo * coef
    mean = ex.luma_mean(buf)
    if cfg.kind == ToneMapperKind.STDDEV_AROUND_MEAN:
        dev = jnp.sqrt(ex.luma_variance(buf, mean))
    elif cfg.kind == ToneMapperKind.ABSDEV_AROUND_MEAN:
        dev = ex.luma_absdev(buf, mean)
    else:
        raise ValueError(f"unknown tone mapper {cfg.kind}")
    coef = float(1 << cfg.dynamic_range)   # dynamic_coef (tone_mapping.ts:40)
    hi = jnp.minimum(mean + dev, cfg.max_dynamic)
    lo = hi / coef
    under = lo < cfg.min_dynamic
    lo = jnp.where(under, cfg.min_dynamic, lo)
    hi = jnp.where(under, lo * coef, hi)
    return lo, hi


def tonemap(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> Array:
    """Apply the window -> [h, w, 3] in [0, 1] (View.draw_ebuffer,
    view/view.ts:34-38)."""
    lo, hi = dynamic_range(buf, cfg)
    return ex.discretize(buf.pixels, lo, hi)
