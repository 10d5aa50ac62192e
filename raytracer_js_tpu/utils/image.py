"""Image I/O for textures.

Re-design of the reference ImageTexture loader
(/root/reference/src/texture/texture_image.ts:76-136): the DOM
Image->canvas->getImageData decode with manual flip loops becomes PIL/NumPy
decode with array ops. The async-with-fallback contract (get_color returns
the fallback color until the image loads, TextureError tolerated —
texture_image.ts:40-44, main.ts:383-388) maps to :func:`load_texture_image`'s
``fallback`` return on failure: scene build is synchronous, so "not yet
loaded" collapses to "failed to load".
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple, Union

import numpy as np

PathLike = Union[str, pathlib.Path]


class TextureError(Exception):
    """Image decode failure (reference texture.ts TextureError)."""


def load_image(path: PathLike, hflip: bool = False,
               vflip: bool = False) -> np.ndarray:
    """Decode an image file -> [H, W, 3] float32 in [0, 1].

    ``hflip``/``vflip`` mirror the reference loader's flip options
    (texture_image.ts:76-136). Raises :class:`TextureError` on failure.
    """
    try:
        from PIL import Image
    except ImportError as e:                     # pragma: no cover
        raise TextureError(f"PIL unavailable: {e}") from e
    try:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception as e:
        raise TextureError(f"failed to decode {path}: {e}") from e
    if hflip:
        arr = arr[:, ::-1]
    if vflip:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)


def load_texture_image(path: PathLike,
                       fallback: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                       hflip: bool = False, vflip: bool = False,
                       size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load an image for :meth:`SceneBuilder.add_image_texture`; on failure
    return a 1x1 image of the fallback color (the reference's graceful
    degradation, main.ts:383-388)."""
    try:
        img = load_image(path, hflip=hflip, vflip=vflip)
    except TextureError:
        return np.full((1, 1, 3), np.asarray(fallback, np.float32))
    if size is not None:
        h, w = size
        yi = np.arange(h) * img.shape[0] // h
        xi = np.arange(w) * img.shape[1] // w
        img = img[yi][:, xi]
    return img
