"""RGBA color operations.

Re-design of the reference's ``src/physics/color.ts``: the per-pixel
RGBA record functions (mul :50-52, scale :38-47, clamp :28-36, alpha overlay
:59-65) become broadcasting ops over ``[..., 4]`` (RGBA) and ``[..., 3]``
(RGB) arrays. The trace path itself carries plain RGB; RGBA overlay exists
for the screen/compositing layer.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def color(r, g, b, a=1.0) -> Array:
    """RGBA constructor (color.ts:21-27)."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(r, jnp.float32), jnp.asarray(g, jnp.float32),
        jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32)), axis=-1)


def mul_color(a: Array, b: Array) -> Array:
    """Component-wise (Hadamard) product (color.ts:50-52) — the alter_ray
    modulation."""
    return a * b


def scale_color(c: Array, factor, scale_alpha: bool = False) -> Array:
    """Scale RGB, optionally alpha (color.ts:38-47)."""
    f = jnp.asarray(factor)[..., None]
    if scale_alpha or c.shape[-1] == 3:
        return c * f
    rgb = c[..., :3] * f
    return jnp.concatenate([rgb, c[..., 3:]], axis=-1)


def clamp_color(c: Array, lo: float = 0.0, hi: float = 1.0) -> Array:
    """Clamp components (color.ts:28-36)."""
    return jnp.clip(c, lo, hi)


def overlay_color(top: Array, bottom: Array) -> Array:
    """Alpha-composite ``top`` over ``bottom`` (color.ts:59-65, exactly):
    ``out_rgb = clamp(top_rgb * a_top + bottom_rgb * (1 - a_top))``;
    alpha saturates additively, ``a_out = clamp(a_bottom + a_top)``
    (color.ts:63 — NOT Porter-Duff "over"). RGBA [..., 4] arrays."""
    a_t = top[..., 3:]
    a_b = bottom[..., 3:]
    rgb = jnp.clip(top[..., :3] * a_t + bottom[..., :3] * (1.0 - a_t),
                   0.0, 1.0)
    a_out = jnp.clip(a_b + a_t, 0.0, 1.0)
    return jnp.concatenate([rgb, a_out], axis=-1)


def luma(c: Array) -> Array:
    """BT.601 luminance of RGB(A) (exposure_buffer.ts:161-173)."""
    w = jnp.asarray([0.299, 0.587, 0.114], c.dtype)
    return jnp.einsum("...c,c->...", c[..., :3], w,
                      precision=jax.lax.Precision.HIGHEST)
