"""Texture tables + branchless sampling.

Re-design of the reference texture class hierarchy
(/root/reference/src/texture/texture.ts:26-35, texture_solid.ts:21-44,
texture_image.ts:20-137): virtual ``get_color(u, v)`` dispatch becomes two
static tables —

* ``solid_rgb [X, 3]`` — every texture's flat color (the SolidTexture color,
  or an image texture's *fallback* color, texture_image.ts:40-44);
* ``atlas [I, H, W, 3]`` — all image textures resized to one static
  resolution (images of equal shape are a hard requirement for fixed-shape
  gathers; the reference decodes arbitrary sizes through a DOM canvas,
  texture_image.ts:76-136 — a browser I/O path replaced here by
  PIL/NumPy in :mod:`raytracer_js_tpu.utils.image`).

Sampling is a gather + ``jnp.where`` select on ``kind`` — no per-texture
control flow, so a whole wavefront samples in one fused op. Nearest-neighbor
filtering matches texture_image.ts:40-63 (bilinear is an explicit TODO there).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..config import TextureKind

Array = jnp.ndarray


@pytree.dataclass
class TextureTable:
    kind: Array        # [X] i32: TextureKind
    ref: Array         # [X] i32: row into atlas for IMAGE kind (0 for solid)
    solid_rgb: Array   # [X, 3] f32: solid color / image fallback
    atlas: Array       # [I, H, W, 3] f32 (I >= 1; row 0 is a dummy when unused)
    #: static: any IMAGE-kind entries? When False the atlas gather is
    #: compiled out entirely (solid colors ride a one-hot matmul).
    has_images: bool = pytree.field(pytree_node=False, default=True)
    #: static: any IMAGE_BILINEAR entries? Gates the 4-tap filtered path
    #: (the extra gathers are compiled out for nearest-only scenes).
    has_bilinear: bool = pytree.field(pytree_node=False, default=False)
    #: per-image NATIVE sizes [I] i32 (images are stored top-left in a
    #: max-size padded atlas). None = every image fills the atlas (the
    #: legacy fixed-resolution mode). The reference samples images at
    #: their decoded resolution (texture_image.ts:40-63); these columns
    #: preserve that fidelity for mixed-size scenes.
    img_h: Array | None = None
    img_w: Array | None = None

    @property
    def n_images(self) -> int:
        return self.atlas.shape[0]


def is_image_kind(kind: Array) -> Array:
    """Bool mask: does this TextureKind sample the atlas (nearest OR
    bilinear)? The single predicate every image-vs-solid dispatch site
    uses."""
    return ((kind == int(TextureKind.IMAGE))
            | (kind == int(TextureKind.IMAGE_BILINEAR)))


#: group size of the two-level one-hot atlas gather (64 texels per
#: one-hot group row); atlases with more than ATLAS_MAX_GROUPS groups fall
#: back to jnp.take
ATLAS_GROUP = 64
ATLAS_MAX_GROUPS = 4096


def _atlas_gather(atlas: Array, img_row: Array, row: Array,
                  col: Array) -> Array:
    """``atlas[img_row, row, col]`` -> [N, 3] texel colors.

    Two levels instead of a per-ray advanced-index gather (whether this
    beats ``jnp.take`` on the GPU is ROADMAP A5's open question): a one-hot
    matmul picks each ray's 64-texel GROUP row from the
    flattened [R/64, 64*3] atlas (exact under Precision.HIGHEST, gradient
    flows to the atlas through the standard transpose — image-texture
    fitting keeps working), then a fused compare-multiply-reduce selects
    the texel within the group. Exact — bit-identical to the take path.
    """
    i, h, w, _ = atlas.shape
    r = i * h * w
    g = ATLAS_GROUP
    n_grp = -(-r // g)
    if n_grp > ATLAS_MAX_GROUPS:
        return atlas[img_row, row, col]
    from ..ops.gather import onehot_gather

    flat = (img_row * (h * w) + row * w + col).astype(jnp.int32)
    tab = atlas.reshape(r, 3)
    if n_grp * g != r:
        tab = jnp.concatenate(
            [tab, jnp.zeros((n_grp * g - r, 3), tab.dtype)], axis=0)
    tabw = tab.reshape(n_grp, g * 3)
    tmp = onehot_gather(flat // g, tabw)                  # [N, g*3]
    lo = flat % g
    sel = (lo[:, None] == jnp.arange(g, dtype=jnp.int32)[None, :])
    # HIGHEST: a lower-precision contraction (TF32 on a GPU) would round
    # the texel colors (the project-wide rule)
    return jnp.einsum("nl,nlc->nc", sel.astype(tab.dtype),
                      tmp.reshape(-1, g, 3),
                      precision=jax.lax.Precision.HIGHEST)


def sample(tex: TextureTable, tex_id: Array, u: Array, v: Array) -> Array:
    """Color of texture ``tex_id`` at (u, v); all args [N]-batched -> [N, 3].

    u, v are in [0, 1) (the trace path guarantees this via the equirect
    epsilon clamp, uv_mapping.ts:19-25; we additionally clamp, where the
    reference throws, texture_image.ts:49-50 — a wavefront cannot throw
    per-lane).

    Texel lookup: ``(ix, iy) = (floor(u*W), floor(v*H))``, row iy from the
    *bottom* of the image — the reference loader vertically flips into
    bottom-up storage at decode time (texture_image.ts:112-127); we keep
    images top-down in memory and flip at sample time instead.
    """
    from ..ops.gather import gather_cols

    tex_id = jnp.clip(tex_id, 0, tex.kind.shape[0] - 1)
    if not tex.has_images:
        (solid,) = gather_cols(tex_id, tex.solid_rgb)
        return solid
    solid, kind, img_row = gather_cols(tex_id, tex.solid_rgb, tex.kind,
                                       tex.ref)
    if tex.img_h is not None:
        # per-image native sizes over the padded atlas
        hi, wi = gather_cols(img_row, tex.img_h, tex.img_w)
        h = hi.astype(jnp.float32)
        w = wi.astype(jnp.float32)
        h_top = hi - 1
        w_hi = wi - 1
    else:
        h, w = tex.atlas.shape[1], tex.atlas.shape[2]
        h_top = h - 1
        w_hi = w - 1
    ix = jnp.clip((u * w).astype(jnp.int32), 0, w_hi)
    iy = jnp.clip((v * h).astype(jnp.int32), 0, h_top)
    img = _atlas_gather(tex.atlas, img_row, h_top - iy, ix)
    if tex.has_bilinear:
        # texel-center bilinear (the reference's texture_image.ts:52 TODO):
        # x = u*W - 0.5 puts integer x on texel centers; the 4 neighbor
        # taps are edge-clamped, weights are the fractional offsets. Same
        # bottom-up row flip as the nearest path.
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i = jnp.clip(x0.astype(jnp.int32), 0, w_hi)
        x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w_hi)
        y0i = jnp.clip(y0.astype(jnp.int32), 0, h_top)
        y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h_top)
        r0 = h_top - y0i
        r1 = h_top - y1i
        c00 = _atlas_gather(tex.atlas, img_row, r0, x0i)
        c10 = _atlas_gather(tex.atlas, img_row, r0, x1i)
        c01 = _atlas_gather(tex.atlas, img_row, r1, x0i)
        c11 = _atlas_gather(tex.atlas, img_row, r1, x1i)
        blin = ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
                + (1 - fx) * fy * c01 + fx * fy * c11)
        img = jnp.where(
            (kind == int(TextureKind.IMAGE_BILINEAR))[..., None], blin, img)
    return jnp.where(is_image_kind(kind)[..., None], img, solid)
