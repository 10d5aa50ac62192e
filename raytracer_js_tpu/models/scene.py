"""Structure-of-arrays scene model.

Re-design of the reference's pointer-based scene graph: the abstract
``Entity`` (/root/reference/src/entity.ts:38-101) with per-object material /
texture / substance references and an octree back-pointer becomes flat
parameter arrays — ``sphere_center [S,3]``, ``sphere_radius [S]``,
``box_center/box_half [B,3]``, triangle vertex arrays (new capability; the
reference's triangle entity is a stub, entities/entity_face.ts:17) — plus
per-primitive id columns into the material / texture / substance tables.

These arrays are the framework's *differentiable parameters*: inverse
rendering optimizes them directly (SURVEY.md §2 #13 "these arrays are the
differentiable leaves").

Global primitive ids are ordered [spheres | boxes | triangles]; every
nearest-hit backend returns ids in this space.

Scene construction is host-side Python (:class:`SceneBuilder`) mirroring the
reference's entity constructors (entity_sphere.ts:34, entity_box.ts:32,
main.ts:97-147); the result is a frozen pytree that jits/shards cleanly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..config import ResponseType, TextureKind
from .materials import MaterialTable, make_material_table
from .textures import TextureTable

Array = jnp.ndarray

#: substance id meaning "undefined": transmission through such an entity does
#: not refract and does not change the ray's current substance
#: (raytracer.ts:243-248).
SUBSTANCE_UNDEFINED = -1

# Reference canned substances (substance.ts:1-11).
REFR_AIR = 1.0
REFR_WATER = 1.333
REFR_GLASS = 1.5


@pytree.dataclass
class Scene:
    # primitives (differentiable leaves)
    sphere_center: Array   # [S, 3]
    sphere_radius: Array   # [S]
    box_center: Array      # [B, 3]
    box_half: Array        # [B, 3]
    tri_v0: Array          # [T, 3]
    tri_v1: Array          # [T, 3]
    tri_v2: Array          # [T, 3]
    # per-primitive ids over the global [spheres|boxes|tris] ordering
    prim_material: Array   # [P] i32
    prim_texture: Array    # [P] i32
    prim_substance: Array  # [P] i32 (SUBSTANCE_UNDEFINED allowed)
    # tables
    materials: MaterialTable
    textures: TextureTable
    sub_refr: Array        # [K] f32 refractive indices
    default_refr: Array    # [] f32: empty-space substance (raytracer.ts:38-39)
    # sky: equirect texture lookup on miss (sky/sky_sphere.ts:22-27)
    sky_tex: int = pytree.field(pytree_node=False, default=0)
    #: cube-map sky: 6 texture ids (+x, -x, +y, -y, +z, -z faces) or None.
    #: The reference's SkyBox is an unimplemented stub (sky/sky_box.ts:17
    #: "not supported yet"); this completes it as capability beyond the
    #: reference — see ops/trace.sky_color for the face convention.
    sky_box: tuple | None = pytree.field(pytree_node=False, default=None)
    # static capability flags — let jit drop whole shading sub-graphs for
    # scenes that cannot exercise them (a transmission substance query is an
    # [N, P] containment matrix per bounce; the roughness scatter draws
    # per-ray threefry bits per bounce). Defaults are conservative.
    has_transmission: bool = pytree.field(pytree_node=False, default=True)
    has_rough: bool = pytree.field(pytree_node=False, default=True)
    #: any material declares ResponseType.BOTH. The reference declares the
    #: value but its trace loop default-returns on it (material.ts:25,
    #: raytracer.ts:250-251) — reproduced when RenderConfig.fresnel_both
    #: is False; True enables the Fresnel-split extension (ops/trace).
    has_both: bool = pytree.field(pytree_node=False, default=False)

    @property
    def n_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_center.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_boxes + self.n_tris


def prim_aabbs(scene: Scene) -> Tuple[Array, Array]:
    """Per-primitive AABBs -> (lo [P,3], hi [P,3]) in global prim order.

    Sphere AABB is the center +- radius cube (entity_sphere.ts:90-96); box
    AABB is itself (entity_box.ts:75-82); triangle AABB is the vertex hull.
    """
    s_lo = scene.sphere_center - scene.sphere_radius[:, None]
    s_hi = scene.sphere_center + scene.sphere_radius[:, None]
    b_lo = scene.box_center - scene.box_half
    b_hi = scene.box_center + scene.box_half
    t_lo = jnp.minimum(jnp.minimum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    t_hi = jnp.maximum(jnp.maximum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    lo = jnp.concatenate([s_lo, b_lo, t_lo], axis=0)
    hi = jnp.concatenate([s_hi, b_hi, t_hi], axis=0)
    return lo, hi


def prim_volumes(scene: Scene) -> Array:
    """Enclosed volume per primitive (triangles: 0 — no interior).

    Used by the innermost-containing-entity rule of the substance point query
    (:func:`raytracer_js_tpu.ops.trace.substance_at`)."""
    s_vol = (4.0 / 3.0) * jnp.pi * scene.sphere_radius ** 3
    b_vol = jnp.prod(2.0 * scene.box_half, axis=-1)
    t_vol = jnp.zeros((scene.n_tris,), s_vol.dtype)
    return jnp.concatenate([s_vol, b_vol, t_vol], axis=0)


class SceneBuilder:
    """Host-side scene assembly (the analogue of main.ts:341-433 scene setup).

    All adders return integer ids. ``build()`` freezes everything into a
    :class:`Scene` pytree with static shapes.
    """

    def __init__(self, atlas_hw: Optional[Tuple[int, int]] = None):
        #: fixed atlas resolution images are nearest-RESIZED to, or None
        #: (the default): every image keeps its NATIVE resolution and the
        #: atlas pads to the largest (the reference samples at decoded
        #: resolution, texture_image.ts:40-63)
        self.atlas_hw = atlas_hw
        self._materials: List[tuple] = []
        self._tex_kind: List[int] = []
        self._tex_ref: List[int] = []
        self._tex_solid: List[np.ndarray] = []
        self._images: List[np.ndarray] = []
        self._substances: List[float] = []
        self._spheres: List[tuple] = []   # (center, radius, mat, tex, sub)
        self._boxes: List[tuple] = []     # (center, half, mat, tex, sub)
        self._tris: List[tuple] = []      # (v0, v1, v2, mat, tex, sub)
        self._sky_tex: Optional[int] = None
        self._sky_box: Optional[tuple] = None
        self._default_refr: float = REFR_AIR

    # -- tables ------------------------------------------------------------
    def add_material(self, response: ResponseType = ResponseType.REFLECTION,
                     light: bool = False, mirror: bool = False,
                     roughness: float = 0.0) -> int:
        self._materials.append((response, light, mirror, roughness))
        return len(self._materials) - 1

    def add_solid_texture(self, rgb) -> int:
        """SolidTexture (texture_solid.ts:21-44)."""
        self._tex_kind.append(int(TextureKind.SOLID))
        self._tex_ref.append(0)
        self._tex_solid.append(np.asarray(rgb, np.float32).reshape(3))
        return len(self._tex_kind) - 1

    def add_image_texture(self, image: np.ndarray, fallback=(0.0, 0.0, 0.0),
                          bilinear: bool = False) -> int:
        """ImageTexture (texture_image.ts:20-137); ``image`` is [H, W, 3]
        float in [0, 1], resized (nearest) to the builder's atlas resolution.
        ``fallback`` mirrors the reference's until-loaded/failed color.
        ``bilinear=True`` opts into 4-tap filtered sampling (the
        reference's texture_image.ts:52 TODO — capability beyond it)."""
        img = np.asarray(image, np.float32)
        assert img.ndim == 3 and img.shape[2] == 3, img.shape
        if self.atlas_hw is not None:
            ah, aw = self.atlas_hw
            if img.shape[:2] != (ah, aw):
                yi = (np.arange(ah) * img.shape[0] // ah)
                xi = (np.arange(aw) * img.shape[1] // aw)
                img = img[yi][:, xi]
        self._images.append(img)
        self._tex_kind.append(int(TextureKind.IMAGE_BILINEAR if bilinear
                                  else TextureKind.IMAGE))
        self._tex_ref.append(len(self._images) - 1)
        self._tex_solid.append(np.asarray(fallback, np.float32).reshape(3))
        return len(self._tex_kind) - 1

    def add_substance(self, refractive_index: float) -> int:
        self._substances.append(float(refractive_index))
        return len(self._substances) - 1

    def set_sky(self, tex_id: int) -> None:
        self._sky_tex = tex_id
        self._sky_box = None

    def set_sky_box(self, face_tex_ids) -> None:
        """Cube-map sky from 6 texture ids, face order
        (+x, -x, +y, -y, +z, -z). Completes the reference's SkyBox stub
        (sky/sky_box.ts:17)."""
        ids = tuple(int(i) for i in face_tex_ids)
        assert len(ids) == 6, ids
        self._sky_box = ids

    def set_default_refr(self, refr: float) -> None:
        self._default_refr = float(refr)

    # -- primitives ----------------------------------------------------------
    def add_sphere(self, center, radius: float, material: int, texture: int,
                   substance: int = SUBSTANCE_UNDEFINED) -> int:
        self._spheres.append((np.asarray(center, np.float32), float(radius),
                              material, texture, substance))
        return len(self._spheres) - 1

    def add_box(self, center, size, material: int, texture: int,
                substance: int = SUBSTANCE_UNDEFINED) -> int:
        """``size`` is the full edge length (scalar, matching the reference's
        cubes, entity_box.ts:32) or a per-axis 3-vector (new capability)."""
        size = np.broadcast_to(np.asarray(size, np.float32), (3,))
        self._boxes.append((np.asarray(center, np.float32), size / 2.0,
                            material, texture, substance))
        return len(self._boxes) - 1

    def add_triangle(self, v0, v1, v2, material: int, texture: int,
                     substance: int = SUBSTANCE_UNDEFINED) -> int:
        self._tris.append((np.asarray(v0, np.float32),
                           np.asarray(v1, np.float32),
                           np.asarray(v2, np.float32),
                           material, texture, substance))
        return len(self._tris) - 1

    def add_mesh(self, vertices, faces, material: int, texture: int,
                 substance: int = SUBSTANCE_UNDEFINED) -> None:
        vertices = np.asarray(vertices, np.float32)
        for f in np.asarray(faces, np.int64):
            self.add_triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]],
                              material, texture, substance)

    # -- build ---------------------------------------------------------------
    def build(self) -> Scene:
        if not self._tex_kind:
            self.add_solid_texture((0.0, 0.0, 0.0))
        if self._sky_tex is None:
            # reference default sky color is black (raytracer.ts:47-50)
            self._sky_tex = self.add_solid_texture((0.0, 0.0, 0.0))
        if not self._substances:
            self.add_substance(REFR_AIR)

        def stack(rows, shape, dtype=np.float32):
            if rows:
                return jnp.asarray(np.stack(rows).astype(dtype))
            return jnp.zeros(shape, dtype)

        sc = stack([s[0] for s in self._spheres], (0, 3))
        sr = stack([s[1] for s in self._spheres], (0,))
        bc = stack([b[0] for b in self._boxes], (0, 3))
        bh = stack([b[1] for b in self._boxes], (0, 3))
        t0 = stack([t[0] for t in self._tris], (0, 3))
        t1 = stack([t[1] for t in self._tris], (0, 3))
        t2 = stack([t[2] for t in self._tris], (0, 3))

        ids = ([s[2:] for s in self._spheres]
               + [b[2:] for b in self._boxes]
               + [t[3:] for t in self._tris])
        mat = jnp.asarray(np.array([i[0] for i in ids], np.int32)
                          if ids else np.zeros((0,), np.int32))
        tex = jnp.asarray(np.array([i[1] for i in ids], np.int32)
                          if ids else np.zeros((0,), np.int32))
        sub = jnp.asarray(np.array([i[2] for i in ids], np.int32)
                          if ids else np.zeros((0,), np.int32))

        # pad every image into a max-size atlas, keeping native (h, w)
        # columns so sampling stays reference-faithful per image
        if self._images:
            ah = max(im.shape[0] for im in self._images)
            aw = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), ah, aw, 3), np.float32)
            img_h = np.empty(len(self._images), np.int32)
            img_w = np.empty(len(self._images), np.int32)
            for k, im in enumerate(self._images):
                atlas[k, : im.shape[0], : im.shape[1]] = im
                img_h[k], img_w[k] = im.shape[0], im.shape[1]
        else:
            ah, aw = self.atlas_hw or (1, 1)
            atlas = np.zeros((1, ah, aw, 3), np.float32)
            img_h = np.full(1, ah, np.int32)
            img_w = np.full(1, aw, np.int32)

        return Scene(
            sphere_center=sc, sphere_radius=sr,
            box_center=bc, box_half=bh,
            tri_v0=t0, tri_v1=t1, tri_v2=t2,
            prim_material=mat, prim_texture=tex, prim_substance=sub,
            materials=make_material_table(self._materials),
            textures=TextureTable(
                kind=jnp.asarray(np.array(self._tex_kind, np.int32)),
                ref=jnp.asarray(np.array(self._tex_ref, np.int32)),
                solid_rgb=jnp.asarray(np.stack(self._tex_solid)),
                atlas=jnp.asarray(atlas),
                img_h=jnp.asarray(img_h),
                img_w=jnp.asarray(img_w),
                has_images=bool(self._images),
                has_bilinear=any(
                    k == int(TextureKind.IMAGE_BILINEAR)
                    for k in self._tex_kind),
            ),
            sub_refr=jnp.asarray(np.array(self._substances, np.float32)),
            default_refr=jnp.asarray(self._default_refr, jnp.float32),
            sky_tex=int(self._sky_tex),
            sky_box=self._sky_box,
            # BOTH rides the transmission machinery (substance query +
            # Snell/TIR), so it implies has_transmission
            has_transmission=any(
                int(self._materials[i[0]][0]) in (
                    int(ResponseType.TRANSMISSION), int(ResponseType.BOTH))
                for i in ids),
            has_rough=any(float(self._materials[i[0]][3]) > 0.0 for i in ids),
            has_both=any(
                int(self._materials[i[0]][0]) == int(ResponseType.BOTH)
                for i in ids),
        )
