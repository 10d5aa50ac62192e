"""Output sinks — the Screen abstraction.

Re-design of the reference Screen/CanvasScreen
(/root/reference/src/view/screen.ts:25-47, screen_canvas.ts): the browser
canvas ``ImageData`` sink becomes u8 quantization (screen_canvas.ts:92-94,
``dynamic_range()`` = 8 bits, :96-98) plus file writers — PNG via PIL when
available, always-available ``.npy``. Batch rendering replaces interactive
flushes (SURVEY.md §2 #31/#33: interactivity is out of scope on an accelerator).
"""
from __future__ import annotations

import pathlib
from typing import Union

import numpy as np

PathLike = Union[str, pathlib.Path]

#: display bit depth (screen_canvas.ts:96-98)
DYNAMIC_RANGE_BITS = 8


def quantize_u8(img) -> np.ndarray:
    """[0,1] float -> u8 (screen_canvas.ts:92-94: round(c * 0xff))."""
    arr = np.asarray(img, np.float32)
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)


def to_rgba(img) -> np.ndarray:
    """[h, w, 3] RGB -> [h, w, 4] RGBA with opaque alpha — the CanvasScreen
    sink writes alpha = 0xff for every rendered pixel
    (screen_canvas.ts:45-56 ``image.data[pos+3] = 0xff``). Pass the result
    through :func:`raytracer_js_tpu.ops.color.overlay_color` to composite
    HUD/overlay layers before quantization."""
    arr = np.asarray(img, np.float32)
    if arr.shape[-1] == 4:
        return arr
    a = np.ones(arr.shape[:-1] + (1,), np.float32)
    return np.concatenate([arr, a], axis=-1)


def write_png(path: PathLike, img) -> pathlib.Path:
    """Write a [h, w, 3] RGB or [h, w, 4] RGBA image in [0, 1] as PNG (falls
    back to .npy when PIL is unavailable). Returns the path actually
    written. RGBA carries the alpha channel through to the file, matching
    the 4-byte-per-pixel ImageData layout of screen_canvas.ts:45-56."""
    path = pathlib.Path(path)
    u8 = quantize_u8(img)
    try:
        from PIL import Image
    except ImportError:
        path = path.with_suffix(".npy")
        np.save(path, u8)
        return path
    mode = "RGBA" if u8.shape[-1] == 4 else "RGB"
    Image.fromarray(u8, mode=mode).save(path)
    return path


def write_npy(path: PathLike, img) -> pathlib.Path:
    """Raw HDR dump for exact golden comparisons."""
    path = pathlib.Path(path).with_suffix(".npy")
    np.save(path, np.asarray(img, np.float32))
    return path
