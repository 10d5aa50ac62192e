"""Progressive HDR exposure accumulation + luma statistics.

Re-design of the reference ``ExposureBuffer``
(/root/reference/src/view/exposure_buffer.ts): the per-pixel Float32Array
running mean (``new*w + old*(1-w)``, ``w = 1/(1+frames)``,
exposure_buffer.ts:53-91) becomes one fused array op over the whole frame,
and the scalar luma scans (mean/variance/absdev, exposure_buffer.ts:93-142)
become jnp reductions.

The buffer is a tiny immutable pytree so it jits/shards with everything
else; ``reset`` replaces the reference's ``reset_exposure`` on camera motion
(exposure_buffer.ts:63-66), and ``max_frames`` replicates the optional
exposure cap (exposure_buffer.ts:53-58, -1 = unlimited).

Reference defects NOT replicated (SURVEY.md §7): the blue channel being
dropped on display (``slice(i,i+2)``, exposure_buffer.ts:153) and the stat
caches that are read but never written (exposure_buffer.ts:93-107).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import pytree

Array = jnp.ndarray

# BT.601 luma weights (exposure_buffer.ts:161-173).
LUMA_W = (0.299, 0.587, 0.114)


@pytree.dataclass
class ExposureBuffer:
    pixels: Array       # [h, w, 3] f32 running-mean HDR
    frame_count: Array  # [] i32 — number of accumulated exposure frames
    max_frames: int = pytree.field(pytree_node=False, default=-1)

    @property
    def shape(self):
        return self.pixels.shape


def new_exposure_buffer(h: int, w: int, max_frames: int = -1) -> ExposureBuffer:
    return ExposureBuffer(pixels=jnp.zeros((h, w, 3), jnp.float32),
                          frame_count=jnp.zeros((), jnp.int32),
                          max_frames=max_frames)


def reset(buf: ExposureBuffer) -> ExposureBuffer:
    """Restart accumulation (camera moved — exposure_buffer.ts:63-66)."""
    return buf.replace(pixels=jnp.zeros_like(buf.pixels),
                       frame_count=jnp.zeros((), jnp.int32))


def accumulate(buf: ExposureBuffer, frame: Array) -> ExposureBuffer:
    """Blend one new exposure frame into the running mean.

    ``w = 1/(1+n)`` with n the *post-increment* frame count, i.e. the k-th
    frame (1-based) enters with weight 1/(1+k)... matching next_frame() then
    set_color(): frame_count is incremented first (exposure_buffer.ts:53-60),
    so frame k gets weight 1/(1+k) — NOT the textbook 1/k running mean. The
    first frame thus enters with weight 1/2 against a zero buffer, which is
    the reference's (quirky but exact) behavior.

    Past ``max_frames`` the buffer is returned unchanged (next_frame() returns
    false and the caller skips the tick, main.ts:210).
    """
    n = buf.frame_count + 1
    w = 1.0 / (1.0 + n.astype(frame.dtype))
    blended = frame * w + buf.pixels * (1.0 - w)
    if buf.max_frames >= 0:
        full = buf.frame_count >= buf.max_frames
        blended = jnp.where(full, buf.pixels, blended)
        n = jnp.where(full, buf.frame_count, n)
    return buf.replace(pixels=blended, frame_count=n)


def luma(pixels: Array) -> Array:
    """BT.601 Y' per pixel (exposure_buffer.ts:161-173)."""
    w = jnp.asarray(LUMA_W, pixels.dtype)
    return jnp.matmul(pixels, w, precision=jax.lax.Precision.HIGHEST)


def luma_mean(buf: ExposureBuffer) -> Array:
    return jnp.mean(luma(buf.pixels))


def luma_variance(buf: ExposureBuffer, mean: Array) -> Array:
    y = luma(buf.pixels)
    return jnp.mean((y - mean) ** 2)


def luma_absdev(buf: ExposureBuffer, mean: Array) -> Array:
    y = luma(buf.pixels)
    return jnp.mean(jnp.abs(y - mean))


def discretize(pixels: Array, drange_low: Array, drange_high: Array) -> Array:
    """HDR -> [0,1] display window (exposure_buffer.ts:145-158).

    Per pixel: brightness-space window remap, then scale RGB by the
    compressed/raw brightness ratio and clamp. All three channels are kept
    (the reference's slice(i,i+2) blue-drop is a documented defect)."""
    y = luma(pixels)
    drange = drange_high - drange_low
    compressed = (y - drange_low) / drange
    scale = compressed / (y + 2.0 ** -52)
    return jnp.clip(pixels * scale[..., None], 0.0, 1.0)
