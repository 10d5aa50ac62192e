"""Fixed-depth iterative wavefront trace loop.

Re-design of the reference's mutable per-ray state machine
(``Ray.trace()``, /root/reference/src/raytracer.ts:166-277): the recursive-ish
while-walker loop becomes ``refmax`` iterations of a masked wavefront pass
over SoA ray-state tensors — traverse → intersect → shade → respawn — with an
explicit per-ray status word instead of control flow (SURVEY.md §7).

Behavioral contract (each rule cites its reference source):

* every hit first modulates the ray color by the hit texture's color at the
  hit UV (``SolidMaterial.alter_ray``, materials/material_solid.ts:30-36,
  invoked at raytracer.ts:209);
* path distance accumulates the org→hit length (raytracer.ts:210);
* emissive hit → terminate; at termination the color is scaled by the
  inverse-square-law coefficient ``1/(eps + (path * A)^2)``
  (raytracer.ts:215-218, 273-275);
* mirror REFLECTION → reflect about the normal (raytracer.ts:231), roughness
  scatter if roughness > 0 (raytracer.ts:233-235), ε-advance along the NEW
  direction (raytracer.ts:236, 158-164);
* non-mirror REFLECTION → terminate keeping the (modulated) color
  (raytracer.ts:222-225, scattering is a TODO there);
* TRANSMISSION → ε-advance along the OLD direction first (raytracer.ts:239),
  look up the substance of the innermost entity containing the advanced
  point (raytracer.ts:240-241), refract with TIR fallback and adopt that
  substance (raytracer.ts:245-248); an entity with *undefined* substance
  means no refraction and no substance change (raytracer.ts:243-248);
* unhandled ResponseType.BOTH → terminate keeping color (the reference's
  default-return, raytracer.ts:250-251);
* miss → color ⊙ sky(dir), terminate (raytracer.ts:267-271);
* ray still alive after ``refmax`` hits → black (raytracer.ts:256-263). Note
  the ordering: an emissive hit on the refmax-th bounce still terminates as
  LIGHT because the reference breaks before the refmax check
  (raytracer.ts:215-218 vs :256).

DOCUMENTED DIVERGENCES (deliberate, defined by the scalar oracle which owns
the allclose contract):

* nearest forward hit (argmin t) instead of first-entity-in-set-order
  (raytracer.ts:186-195) — SURVEY.md §7 hard part 3;
* physically-correct Snell refraction (see ops/vecmath.refract) instead of
  the reference's malformed update (raytracer.ts:135-150);
* the substance point query picks the *innermost containing* entity
  (smallest enclosed volume) instead of first-in-set-order at one octree
  node (octree_entity.ts:191-202);
* the acute-normal early return (raytracer.ts:199-203) is unreachable here
  because surface normals are flipped against the incoming direction by
  construction.

Autodiff: the nearest-hit *search* (argmin indices, octree cells) is
discrete and runs under ``stop_gradient``; gradients flow only through the
differentiable per-hit surface recompute (ops/intersect ``*_surface``), the
color-modulation products, the ISL attenuation, and the sky/texture lookups
— the VJP boundary SURVEY.md §7 prescribes.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree

from ..config import EPS_ADVANCE, JS_EPSILON, HitBackend, RayStatus, RenderConfig, ResponseType
from ..models import textures as tex_mod
from ..models.scene import Scene, prim_volumes
from . import intersect, sampling
from .gather import gather_cols, gather_rows, gather_rows_pair
from .vecmath import dot, reflect, refract, uv_map_sphere

Array = jnp.ndarray


@pytree.dataclass
class RayState:
    """SoA wavefront state (the reference's per-``Ray`` fields,
    raytracer.ts:55-99, as [N]-leading tensors)."""

    org: Array      # [N, 3] current origin (refpoint)
    dir: Array      # [N, 3] unit direction
    color: Array    # [N, 3] accumulated modulation (starts white)
    path: Array     # [N] path distance for ISL
    refr: Array     # [N] current substance refractive index
    status: Array   # [N] i32 RayStatus


# ---------------------------------------------------------------------------
# Nearest hit (brute backend; the octree backend plugs in here)
# ---------------------------------------------------------------------------

def nearest_hit_brute(scene: Scene, org: Array, dir: Array) -> Tuple[Array, Array]:
    """Dense nearest-forward-hit: [N] rays x all prims -> (t [N], pid [N]).

    ``pid`` indexes the global [spheres|boxes|tris] ordering; -1 on miss.
    The per-type hit matrices are elementwise expressions that XLA fuses
    into the argmin reduction. This replaces the walker's per-node entity
    scan when the scene is small enough that culling loses.
    """
    parts = []
    if scene.n_spheres:
        parts.append(intersect.sphere_hit_t(org, dir, scene.sphere_center,
                                            scene.sphere_radius))
    if scene.n_boxes:
        parts.append(intersect.box_hit_t(org, dir, scene.box_center,
                                         scene.box_half))
    if scene.n_tris:
        parts.append(intersect.tri_hit_t(org, dir, scene.tri_v0,
                                         scene.tri_v1, scene.tri_v2))
    if not parts:
        n = org.shape[0]
        return jnp.full((n,), jnp.inf, org.dtype), jnp.full((n,), -1, jnp.int32)
    # global prim ids must account for skipped empty classes
    offsets = []
    off = 0
    for cls_n, present in ((scene.n_spheres, scene.n_spheres > 0),
                           (scene.n_boxes, scene.n_boxes > 0),
                           (scene.n_tris, scene.n_tris > 0)):
        if present:
            offsets.append(off)
        off += cls_n
    t_all = jnp.concatenate(parts, axis=1)                     # [N, P']
    local = jnp.argmin(t_all, axis=1).astype(jnp.int32)        # [N]
    t = jnp.min(t_all, axis=1)
    # map local column -> global prim id (static shape arithmetic)
    widths = [p.shape[1] for p in parts]
    gid = local
    lo = 0
    for base, width in zip(offsets, widths):
        in_k = (local >= lo) & (local < lo + width)
        gid = jnp.where(in_k, local - lo + base, gid)
        lo += width
    pid = jnp.where(jnp.isfinite(t), gid, -1)
    return t, pid


def nearest_hit(scene: Scene, cfg: RenderConfig, org: Array, dir: Array,
                accel=None) -> Tuple[Array, Array]:
    """Backend dispatch for the nearest-hit search (all discrete; callers
    stop_gradient the results)."""
    if cfg.backend == HitBackend.OCTREE and accel is not None:
        from ..accel.octree import nearest_hit_octree

        # The DDA is a while_loop and cannot be linearized: sever gradients
        # at the inputs so the search traces as a purely primal subgraph.
        org, dir, scene = jax.tree_util.tree_map(jax.lax.stop_gradient,
                                                 (org, dir, scene))
        return nearest_hit_octree(scene, accel, org, dir)
    # BRUTE, OCTREE without a built accel, and FUSED reaching the XLA loop
    # (off-class scenes) all use the dense search.
    return nearest_hit_brute(scene, org, dir)


# ---------------------------------------------------------------------------
# Differentiable surface recompute
# ---------------------------------------------------------------------------

def prim_rows(scene: Scene):
    """Unified [P, C] per-prim attribute table — the differentiable
    gather boundary of the bounce loop.

    Separate per-bounce gathers (sphere c/r, box c/h, prim tex/mat ids,
    material columns, solid texture rgb) would each be a fusion boundary
    with an [N, C] round trip through device memory in both autodiff
    directions. This table joins everything a bounce needs into one row per
    primitive, so :func:`_bounce` costs ONE row gather per bounce. Gradients
    flow through the concat/pre-join to every Scene leaf.

    Returns ``(grad_tab, disc_tab)`` — gathered per bounce with ONE shared
    one-hot operand (gather.gather_rows_pair): the discrete columns ride
    under ``stop_gradient`` (their cotangents are dropped by
    float_partition anyway).

    ``grad_tab`` [P, g + 1 (+3)] (g = 9 when the scene has triangles,
    else 6) — the differentiable columns:

    ========  =======================================================
    0:3       sphere center / box center / tri v0
    3:6       (radius, 0, 0) / box half / tri v1
    6:9       zeros / zeros / tri v2            (only when n_tris > 0)
    g         material roughness (pre-joined per prim)
    g+1:g+4   solid texture rgb (pre-joined; only when the texture
              table has no images — image scenes sample per ray)
    ========  =======================================================

    ``disc_tab`` [P, 4] — light, mirror, response, texture id (exact
    through f32 below 2^24, same contract as gather_cols).

    Returns ``None`` for empty scenes.
    """
    if scene.n_prims == 0:
        return None
    with_tri = scene.n_tris > 0
    f32 = jnp.float32

    def geom(ga, gb, gc):
        cols = [ga, gb] + ([gc] if with_tri else [])
        return jnp.concatenate(cols, axis=1)

    parts = []
    if scene.n_spheres:
        s = scene.n_spheres
        gb = jnp.concatenate([scene.sphere_radius[:, None],
                              jnp.zeros((s, 2), f32)], axis=1)
        parts.append(geom(scene.sphere_center, gb, jnp.zeros((s, 3), f32)))
    if scene.n_boxes:
        parts.append(geom(scene.box_center, scene.box_half,
                          jnp.zeros((scene.n_boxes, 3), f32)))
    if scene.n_tris:
        parts.append(geom(scene.tri_v0, scene.tri_v1, scene.tri_v2))
    g = jnp.concatenate(parts, axis=0)                       # [P, 6|9]

    mat = scene.materials
    light, mirror, response, rough = gather_cols(
        scene.prim_material, mat.light, mat.mirror, mat.response,
        mat.roughness)
    cols = [g, rough.astype(f32)[:, None]]
    if not scene.textures.has_images:
        (rgb,) = gather_cols(scene.prim_texture, scene.textures.solid_rgb)
        cols.append(rgb)
    grad_tab = jnp.concatenate(cols, axis=1)
    # disc_tab roundtrips ints through the f32 one-hot matmul — apply the
    # same 2^24 exactness guard gather_cols applies to its int tables
    from .gather import _check_int_exact

    _check_int_exact(scene.prim_texture)
    disc_tab = jnp.concatenate(
        [light.astype(f32)[:, None], mirror.astype(f32)[:, None],
         response.astype(f32)[:, None],
         scene.prim_texture.astype(f32)[:, None]], axis=1)
    return grad_tab, disc_tab


def _surface_from_rows(scene: Scene, org: Array, dir: Array, pid_c: Array,
                       rows: Array, need_uv: bool):
    """surface_at from pre-gathered unified rows (same selection masks).

    Every class kernel runs on every lane from the SAME rows (degenerate
    params on foreign lanes are eps-guarded NaN-free in primal and
    gradient — see intersect.sphere_surface/box_surface); the winner is
    picked by the pid range masks. ``need_uv=False`` skips the uv math
    entirely (solid-texture scenes pre-join rgb, so the equirect atan2 and
    its VJP fold away).
    """
    n = org.shape[0]
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    ga = rows[:, 0:3]
    gb = rows[:, 3:6]

    point = jnp.zeros_like(org)
    normal = jnp.zeros_like(org)
    uu = jnp.zeros((n,), org.dtype)
    vv = jnp.zeros((n,), org.dtype)
    tt = jnp.zeros((n,), org.dtype)

    def put(m, p, nrm, u, v, t):
        nonlocal point, normal, uu, vv, tt
        point = jnp.where(m[:, None], p, point)
        normal = jnp.where(m[:, None], nrm, normal)
        if need_uv:
            uu = jnp.where(m, u, uu)
            vv = jnp.where(m, v, vv)
        tt = jnp.where(m, t, tt)

    if scene.n_spheres:
        t, p, nrm, (u, v) = intersect.sphere_surface(org, dir, ga, gb[:, 0])
        put(pid_c < s_end, p, nrm, u, v, t)
    if scene.n_boxes:
        t, p, nrm, (u, v) = intersect.box_surface(org, dir, ga, gb)
        put((pid_c >= s_end) & (pid_c < b_end), p, nrm, u, v, t)
    if scene.n_tris:
        t, p, nrm, (u, v) = intersect.tri_surface(org, dir, ga, gb,
                                                  rows[:, 6:9])
        put(pid_c >= b_end, p, nrm, u, v, t)
    return point, normal, uu, vv, tt


def surface_at(scene: Scene, org: Array, dir: Array, pid: Array):
    """(point, normal, u, v, t) of primitive ``pid`` per ray — differentiable.

    ``pid`` is a discrete (stopped) index; geometry params are gathered per
    ray and re-intersected analytically so hit position/normal/uv carry
    gradients to the primitive parameter arrays (the VJP boundary).
    Miss lanes (pid < 0) produce garbage that callers mask; all lanes are
    NaN-free in both primal and gradient.
    """
    n = org.shape[0]
    pid_c = jnp.clip(pid, 0, max(scene.n_prims - 1, 0))
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes

    point = jnp.zeros_like(org)
    normal = jnp.zeros_like(org)
    uu = jnp.zeros((n,), org.dtype)
    vv = jnp.zeros((n,), org.dtype)
    tt = jnp.zeros((n,), org.dtype)

    if scene.n_spheres:
        idx = jnp.clip(pid_c, 0, s_end - 1)
        c, r = gather_cols(idx, scene.sphere_center, scene.sphere_radius)
        t, p, nrm, (u, v) = intersect.sphere_surface(org, dir, c, r)
        m = (pid_c < s_end)
        point = jnp.where(m[:, None], p, point)
        normal = jnp.where(m[:, None], nrm, normal)
        uu = jnp.where(m, u, uu)
        vv = jnp.where(m, v, vv)
        tt = jnp.where(m, t, tt)
    if scene.n_boxes:
        idx = jnp.clip(pid_c - s_end, 0, scene.n_boxes - 1)
        c, h = gather_cols(idx, scene.box_center, scene.box_half)
        t, p, nrm, (u, v) = intersect.box_surface(org, dir, c, h)
        m = (pid_c >= s_end) & (pid_c < b_end)
        point = jnp.where(m[:, None], p, point)
        normal = jnp.where(m[:, None], nrm, normal)
        uu = jnp.where(m, u, uu)
        vv = jnp.where(m, v, vv)
        tt = jnp.where(m, t, tt)
    if scene.n_tris:
        idx = jnp.clip(pid_c - b_end, 0, scene.n_tris - 1)
        v0, v1, v2 = gather_cols(idx, scene.tri_v0, scene.tri_v1,
                                 scene.tri_v2)
        t, p, nrm, (u, v) = intersect.tri_surface(org, dir, v0, v1, v2)
        m = pid_c >= b_end
        point = jnp.where(m[:, None], p, point)
        normal = jnp.where(m[:, None], nrm, normal)
        uu = jnp.where(m, u, uu)
        vv = jnp.where(m, v, vv)
        tt = jnp.where(m, t, tt)
    return point, normal, uu, vv, tt


# ---------------------------------------------------------------------------
# Substance point query (TRANSMISSION refraction target)
# ---------------------------------------------------------------------------

def substance_refr_at(scene: Scene, point: Array, cur_refr: Array,
                      accel=None):
    """Refraction target at ``point`` — the ``entity_at_pos`` analogue
    (octree_entity.ts:191-202 used at raytracer.ts:240-248).

    Returns ``(target_refr [N], do_refract [N])``:

    * innermost containing entity with a defined substance → its index,
      refract;
    * innermost containing entity with undefined substance → keep current
      substance, do NOT refract (raytracer.ts:243-248);
    * no containing entity → the scene default substance, refract.

    With ``accel`` the containment test runs over the grid-cell candidate
    superset (accel.octree.point_query_candidates) instead of the dense
    [N, P] matrix — the octree point query the reference uses, mandatory
    for transmission at large prim counts (an [N, P] bool at 1080p x 100k
    prims would be ~200 GB logical).
    """
    n = point.shape[0]
    if scene.n_prims == 0:
        return jnp.broadcast_to(scene.default_refr, (n,)), jnp.ones((n,), bool)
    if accel is not None:
        from ..accel.octree import point_query_candidates, prim_contains

        pid = point_query_candidates(accel, point)              # [N, C]
        contained = prim_contains(scene, point[:, None, :], pid)
        vols = prim_volumes(scene)
        pid_c = jnp.clip(pid, 0, scene.n_prims - 1)
        score = jnp.where(contained, vols[pid_c], jnp.inf)
        j = jnp.argmin(score, axis=1)
        ent = pid_c[jnp.arange(n), j]                           # innermost
        any_inside = jnp.any(contained, axis=1)
        sub_id = scene.prim_substance[ent]
        defined = sub_id >= 0
        sub_refr = scene.sub_refr[
            jnp.clip(sub_id, 0, scene.sub_refr.shape[0] - 1)]
        target = jnp.where(
            any_inside,
            jnp.where(defined, sub_refr, cur_refr),
            jnp.broadcast_to(scene.default_refr, (n,)))
        return target, jnp.where(any_inside, defined, True)
    inside_parts = []
    if scene.n_spheres:
        d2 = jnp.sum(
            (point[:, None, :] - scene.sphere_center[None, :, :]) ** 2, -1)
        inside_parts.append(d2 <= scene.sphere_radius[None, :] ** 2)
    if scene.n_boxes:
        rel = jnp.abs(point[:, None, :] - scene.box_center[None, :, :])
        inside_parts.append(
            jnp.all(rel <= scene.box_half[None, :, :], axis=-1))
    if scene.n_tris:
        inside_parts.append(
            jnp.zeros((n, scene.n_tris), bool))  # triangles have no interior
    inside = jnp.concatenate(inside_parts, axis=1)             # [N, P]
    vol = prim_volumes(scene)[None, :]                         # [1, P]
    score = jnp.where(inside, vol, jnp.inf)
    ent = jnp.argmin(score, axis=1).astype(jnp.int32)          # innermost
    any_inside = jnp.any(inside, axis=1)
    sub_id = scene.prim_substance[ent]                         # [N]
    defined = sub_id >= 0
    sub_refr = scene.sub_refr[jnp.clip(sub_id, 0, scene.sub_refr.shape[0] - 1)]
    target = jnp.where(
        any_inside,
        jnp.where(defined, sub_refr, cur_refr),
        jnp.broadcast_to(scene.default_refr, (n,)),
    )
    do_refract = jnp.where(any_inside, defined, True)
    return target, do_refract


def sky_color(scene: Scene, dir: Array) -> Array:
    """Environment color for a direction.

    SkySphere: equirect lookup (sky/sky_sphere.ts:22-27). With
    ``scene.sky_box`` set: cube-map lookup — the reference's SkyBox is an
    unimplemented stub (sky/sky_box.ts:17), so the face convention here is
    the standard GL one mapped to this scene's axes: faces ordered
    (+x, -x, +y, -y, +z, -z) by the dominant |component| of ``dir``, with

        +x: (u,v) <- (-z/ax, -y/ax)   -x: (+z/ax, -y/ax)
        +y: (u,v) <- (+x/ay, +z/ay)   -y: (+x/ay, -z/ay)
        +z: (u,v) <- (+x/az, -y/az)   -z: (-x/az, -y/az)

    then remapped from [-1, 1] to [0, 1]. Branchless: all six (face, u, v)
    candidates are computed and the winner selected by the dominant-axis
    mask (two compares), so a whole wavefront samples in one fused op.
    """
    if scene.sky_box is None:
        u, v = uv_map_sphere(dir)
        tex_id = jnp.full(u.shape, scene.sky_tex, jnp.int32)
        return tex_mod.sample(scene.textures, tex_id, u, v)
    x, y, z = dir[..., 0], dir[..., 1], dir[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    inv = 1.0 / jnp.maximum(jnp.maximum(ax, ay), jnp.maximum(az, 1e-20))
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    z_major = ~(x_major | y_major)
    face = jnp.where(
        x_major, jnp.where(x >= 0, 0, 1),
        jnp.where(y_major, jnp.where(y >= 0, 2, 3),
                  jnp.where(z >= 0, 4, 5))).astype(jnp.int32)
    sc = jnp.where(
        x_major, jnp.where(x >= 0, -z, z),
        jnp.where(y_major, x, jnp.where(z >= 0, x, -x)))
    tc = jnp.where(
        x_major, -y,
        jnp.where(y_major, jnp.where(y >= 0, z, -z), -y))
    eps = jnp.float32(2.0 ** -23)
    u = jnp.clip(0.5 * (sc * inv + 1.0), 0.0, 1.0 - eps)
    v = jnp.clip(0.5 * (tc * inv + 1.0), 0.0, 1.0 - eps)
    face_tex = jnp.asarray(scene.sky_box, jnp.int32)       # static [6]
    return tex_mod.sample(scene.textures, face_tex[face], u, v)


# ---------------------------------------------------------------------------
# The bounce loop
# ---------------------------------------------------------------------------

def _bounce(scene: Scene, cfg: RenderConfig, accel, state: RayState,
            rng, bounce: Array, pid_override: Array | None = None,
            prows: Tuple[Array, Array] | None = None) -> RayState:
    """One wavefront pass: traverse -> intersect -> shade -> respawn.

    ``pid_override`` [N] replaces the nearest-hit SEARCH with a given
    winner per ray (-1 = miss) — the path-replay mode: the discrete part
    of the trace is supplied (recorded by any forward backend), and this
    pass recomputes only the continuous factors differentiably. Gradients
    are identical to the search path because the search result is
    stop_gradient'ed there anyway.

    ``prows`` is the :func:`prim_rows` table (built once per trace by the
    loop drivers); everything the shading needs comes from ONE row gather
    per bounce.
    """
    alive = state.status == int(RayStatus.ALIVE)

    if pid_override is not None:
        pid = jax.lax.stop_gradient(pid_override)
    else:
        _t_hit, pid = nearest_hit(scene, cfg, state.org, state.dir, accel)
        pid = jax.lax.stop_gradient(pid)
    hit = alive & (pid >= 0)

    if scene.n_prims == 0:
        # Pure-sky scene: every alive ray misses immediately.
        sky = sky_color(scene, state.dir)
        color = jnp.where(alive[:, None], state.color * sky, state.color)
        status = jnp.where(alive, int(RayStatus.MISS), state.status)
        return state.replace(color=color, status=status)

    if prows is None:
        prows = prim_rows(scene)
    grad_tab, disc_tab = prows
    g = 9 if scene.n_tris else 6
    has_img = scene.textures.has_images
    pid_cc = jnp.clip(pid, 0, scene.n_prims - 1)
    rows, flags = gather_rows_pair(grad_tab, disc_tab, pid_cc)

    point, normal, u, v, t_surf = _surface_from_rows(
        scene, state.org, state.dir, pid_cc, rows, need_uv=has_img)

    # alter_ray: color *= texture(uv) (material_solid.ts:30-36)
    if has_img:
        tex_id = jnp.round(flags[:, 3]).astype(jnp.int32)
        tex_rgb = tex_mod.sample(scene.textures, tex_id, u, v)
    else:
        tex_rgb = rows[:, g + 1:g + 4]                 # pre-joined solid rgb
    color = jnp.where(hit[:, None], state.color * tex_rgb, state.color)

    # path distance (raytracer.ts:210); dir is unit so |point - org| = t
    path = jnp.where(hit, state.path + t_surf, state.path)

    # material columns (pre-joined per prim in the rows tables)
    m_light = flags[:, 0] > 0.5
    is_mirror = flags[:, 1] > 0.5
    response = jnp.round(flags[:, 2]).astype(jnp.int32)
    roughness = rows[:, g]
    is_light = m_light & hit

    is_refl = response == int(ResponseType.REFLECTION)
    is_trans = response == int(ResponseType.TRANSMISSION)

    # --- REFLECTION (mirror) -------------------------------------------------
    refl_dir = reflect(state.dir, normal)
    if scene.has_rough:
        seed, rid = rng
        refl_dir = sampling.scatter_direction(seed, rid, bounce, refl_dir,
                                              normal, roughness)
    # --- TRANSMISSION (compiled out for scenes without it) -------------------
    adv_point = point + EPS_ADVANCE * state.dir        # ε-advance, OLD dir
    if scene.has_transmission:
        target_refr, do_refract = substance_refr_at(scene, adv_point,
                                                    state.refr, accel=accel)
        eta = state.refr / jnp.maximum(target_refr, 1e-6)
        refr_dir, tir = refract(state.dir, normal, eta)
        trans_dir = jnp.where(do_refract[:, None], refr_dir, state.dir)
        new_refr = jnp.where(do_refract, target_refr, state.refr)
    else:
        trans_dir, new_refr = state.dir, state.refr

    # --- select continuation -------------------------------------------------
    cont_mirror = hit & ~is_light & is_refl & is_mirror
    cont_trans = hit & ~is_light & is_trans & scene.has_transmission
    if scene.has_both and cfg.fresnel_both:
        # Genuine ResponseType.BOTH (EXTENSION — the reference declares
        # the value but its trace loop default-returns, material.ts:25,
        # raytracer.ts:250-251): continue as the REFLECTED or REFRACTED
        # ray with Schlick probability R = r0 + (1-r0)(1-cos)^5 drawn
        # from the (seed, ray id, bounce) counter RNG — single-sample
        # unbiased, wavefront-shaped (no ray duplication), bitwise
        # identical across backends and in the scalar oracle. TIR forces
        # the reflect branch (probability 1).
        seed_b, rid_b = rng
        is_both = response == int(ResponseType.BOTH)
        cos_i = jnp.clip(jnp.abs(jnp.sum(state.dir * normal, axis=-1)),
                         0.0, 1.0)
        n2 = jnp.maximum(target_refr, 1e-6)
        r0 = ((state.refr - n2) / (state.refr + n2)) ** 2
        fres = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
        # no substance boundary -> no reflectance (pass through); TIR at
        # a real boundary -> reflect with probability 1
        fres = jnp.where(do_refract, jnp.where(tir, 1.0, fres), 0.0)
        u_f = sampling.ray_uniform(seed_b, rid_b, bounce,
                                   sampling.SALT_FRESNEL)
        cont_both = hit & ~is_light & is_both
        cont_mirror = cont_mirror | (cont_both & (u_f < fres))
        cont_trans = cont_trans | (cont_both & ~(u_f < fres))
    cont = cont_mirror | cont_trans

    new_dir = jnp.where(cont_trans[:, None], trans_dir,
                        jnp.where(cont_mirror[:, None], refl_dir, state.dir))
    new_org = jnp.where(
        cont_trans[:, None], adv_point,
        jnp.where(cont_mirror[:, None], point + EPS_ADVANCE * refl_dir,
                  state.org))
    refr_out = jnp.where(cont_trans, new_refr, state.refr)

    # --- terminations ---------------------------------------------------------
    miss = alive & (pid < 0)
    sky = sky_color(scene, state.dir)
    color = jnp.where(miss[:, None], color * sky, color)

    keep = hit & ~is_light & ~cont                      # non-mirror refl / BOTH
    status = state.status
    status = jnp.where(is_light, int(RayStatus.LIGHT), status)
    status = jnp.where(keep, int(RayStatus.KEEP), status)
    status = jnp.where(miss, int(RayStatus.MISS), status)

    return RayState(org=new_org, dir=new_dir, color=color, path=path,
                    refr=refr_out, status=status)


def record_paths(scene: Scene, cfg: RenderConfig, org: Array, dir: Array,
                 key: Array, ray_id: Array,
                 start_refr: Array | None = None, accel=None) -> Array:
    """Run the (non-differentiable) forward search and record the winner
    primitive per bounce -> pid_seq [N, refmax] (-1 = miss/dead).

    Feed the result to :func:`trace_rays`'s ``pid_seq`` for the
    path-replay backward pass. Everything here is stop_gradient'ed — the
    recording is pure bookkeeping of the discrete trace structure.
    """
    n = org.shape[0]
    if start_refr is None:
        start_refr = jnp.broadcast_to(scene.default_refr, (n,))
    zeros = jnp.zeros_like(org[..., 0])
    state = RayState(org=org, dir=dir, color=jnp.ones_like(org),
                     path=zeros, refr=start_refr + zeros,
                     status=zeros.astype(jnp.int32))
    rng = ((sampling.seed_from_key(key), ray_id)
           if scene.has_rough or (scene.has_both and cfg.fresnel_both)
           else None)
    # derive the recording from ``org`` so the fori_loop carry is uniformly
    # device-varying under shard_map (same reason as trace_rays' state init)
    rec = jnp.broadcast_to((zeros.astype(jnp.int32) - 1)[:, None],
                           (n, cfg.refmax))

    prows = prim_rows(scene)

    def body(b, carry):
        st, rec = carry
        alive = st.status == int(RayStatus.ALIVE)
        _t, pid = nearest_hit(scene, cfg, st.org, st.dir, accel)
        pid = jnp.where(alive, pid, -1)
        rec = jax.lax.dynamic_update_slice(rec, pid[:, None], (0, b))
        st = _bounce(scene, cfg, accel, st, rng, b, pid_override=pid,
                     prows=prows)
        return st, rec

    _, rec = jax.lax.fori_loop(0, cfg.refmax, body, (state, rec),
                               unroll=cfg.unroll)
    return jax.lax.stop_gradient(rec)


def trace_rays(scene: Scene, cfg: RenderConfig, org: Array, dir: Array,
               key: Array, ray_id: Array, start_refr: Array | None = None,
               accel=None, pid_seq: Array | None = None) -> RayState:
    """Trace a wavefront of N rays to termination.

    ``ray_id`` is the global pixel/sample id used for sharding-stable RNG.
    ``start_refr`` is the substance at the camera (the reference looks it up
    once per frame, raytracer.ts:312-313); defaults to the scene default.
    ``pid_seq`` [N, refmax] switches to PATH-REPLAY mode: the per-bounce
    winners come from a recorded forward pass (any backend) instead of a
    search, so the differentiable replay costs O(N * refmax) gathers with
    NO dependence on the primitive count — the inverse-rendering path for
    big scenes (the search result is stop_gradient'ed either way, so
    gradients are identical to the search path).
    Returns the final RayState; LIGHT rays already carry ISL attenuation,
    EXHAUST rays are black.
    """
    n = org.shape[0]
    if start_refr is None:
        start_refr = jnp.broadcast_to(scene.default_refr, (n,))
    # REPLAY mode auto-unrolls small bounce loops: the replay graph has no
    # search, so unrolling compiles quickly and lets XLA fuse across
    # bounces. Search-mode traces keep cfg.unroll.
    unroll = cfg.unroll or (pid_seq is not None and cfg.refmax <= 4)
    # Derive the fresh per-ray state from ``org`` so that under shard_map the
    # whole fori_loop carry is uniformly device-varying (a replicated
    # jnp.zeros initial value trips the scan vma check).
    zeros = jnp.zeros_like(org[..., 0])
    state = RayState(
        org=org,
        dir=dir,
        color=jnp.ones_like(org),            # COLOR_WHITE (raytracer.ts:324)
        path=zeros,
        refr=start_refr + zeros,
        status=zeros.astype(jnp.int32),
    )
    # Counter RNG coordinates (seed, global ray id) — only drawn from when
    # some material scatters (rough mirrors, or the Fresnel-BOTH split).
    rng = ((sampling.seed_from_key(key), ray_id)
           if scene.has_rough or (scene.has_both and cfg.fresnel_both)
           else None)

    # Under cfg.remat the loop carry is kept FLAT ([n*3] instead of
    # [n, 3]) so no loop buffer carries a padded minor dimension of 3;
    # the [n, 3] views inside stay fused.
    def _pack(st):
        return (st.org.reshape(-1), st.dir.reshape(-1),
                st.color.reshape(-1), st.path, st.refr, st.status)

    def _unpack(f):
        return RayState(org=f[0].reshape(-1, 3), dir=f[1].reshape(-1, 3),
                        color=f[2].reshape(-1, 3), path=f[3], refr=f[4],
                        status=f[5])

    prows = prim_rows(scene)

    if cfg.remat:
        # recompute each bounce in the backward pass instead of saving its
        # residuals (see RenderConfig.remat)
        def body(b, flat):
            st = _unpack(flat)
            if pid_seq is not None:
                st = _bounce(scene, cfg, accel, st, rng, b,
                             pid_override=pid_seq[:, b], prows=prows)
            else:
                st = _bounce(scene, cfg, accel, st, rng, b, prows=prows)
            return _pack(st)

        body = jax.checkpoint(body, static_argnums=())
        state = _unpack(jax.lax.fori_loop(0, cfg.refmax, body,
                                          _pack(state),
                                          unroll=unroll))
    else:
        def body(b, st):
            if pid_seq is not None:
                return _bounce(scene, cfg, accel, st, rng, b,
                               pid_override=pid_seq[:, b], prows=prows)
            return _bounce(scene, cfg, accel, st, rng, b, prows=prows)

        state = jax.lax.fori_loop(0, cfg.refmax, body, state,
                                  unroll=unroll)

    # One final pass for rays that survived refmax bounces without a hit
    # resolution in the loop: rays still ALIVE after refmax hits -> black
    # (raytracer.ts:256-263). Rays that never hit anything got MISS inside
    # the loop's first iteration, so ALIVE here == refmax continuations.
    exhausted = state.status == int(RayStatus.ALIVE)
    color = jnp.where(exhausted[:, None], 0.0, state.color)
    status = jnp.where(exhausted, int(RayStatus.EXHAUST), state.status)

    # ISL attenuation for light hits (raytracer.ts:273-275).
    isl = 1.0 / (JS_EPSILON +
                 (state.path * cfg.distance_attenuation_factor) ** 2)
    lit = status == int(RayStatus.LIGHT)
    color = jnp.where(lit[:, None], color * isl[:, None], color)
    return state.replace(color=color, status=status)
