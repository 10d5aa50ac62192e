"""View glue — tone-map window -> discretize -> sink.

The analogue of the reference ``View`` (/root/reference/src/view/view.ts:23-41)
composed with the progressive loop of main.ts:210: ``progressive_render``
drives render -> accumulate -> tonemap across exposure frames, the batch
equivalent of the reference's 60 Hz accumulation ticks (SURVEY.md §3.5).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig, ToneMapConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..render import render_hdr
from . import exposure as ex
from .tonemap import tonemap

Array = jnp.ndarray


def draw(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> Array:
    """ExposureBuffer -> display-ready [0,1] image (view.ts:34-38)."""
    return tonemap(buf, cfg)


def draw_rgba(buf: ex.ExposureBuffer, cfg: ToneMapConfig,
              overlays: tuple = ()) -> Array:
    """RGBA display path: tone-map, promote to opaque RGBA (the CanvasScreen
    sink writes alpha = 0xff per pixel, screen_canvas.ts:45-56), then
    alpha-composite each ``overlays`` layer ([h, w, 4] RGBA, e.g. a HUD) on
    top via ops/color.overlay_color (color.ts:59-65). Returns [h, w, 4]
    ready for ``screen.write_png``."""
    from ..ops.color import overlay_color

    rgb = tonemap(buf, cfg)
    img = jnp.concatenate(
        [rgb, jnp.ones(rgb.shape[:-1] + (1,), rgb.dtype)], axis=-1)
    for layer in overlays:
        img = overlay_color(jnp.asarray(layer, rgb.dtype), img)
    return img


def progressive_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                       tone: ToneMapConfig, frames: int,
                       key: Optional[Array] = None) -> Array:
    """Render ``frames`` exposure frames with per-frame RNG, accumulating the
    running mean (exposure_buffer.ts:53-91), then tone-map. Each frame uses a
    distinct fold of the key — the reference's per-frame scatter variation."""
    if key is None:
        key = jax.random.key(0)
    buf = ex.new_exposure_buffer(camera.h, camera.w)
    for f in range(frames):
        frame = render_hdr(scene, camera, cfg, key=jax.random.fold_in(key, f))
        buf = ex.accumulate(buf, frame)
    return draw(buf, tone)
