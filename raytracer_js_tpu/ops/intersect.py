"""Batched analytic ray-primitive intersection.

Re-design of the reference's scalar intersection module
(/root/reference/src/math/intersection.ts): instead of one ray against one
shape returning a param list, every function here evaluates a *wavefront* of
rays against a *table* of primitives as dense array math.

Two layers:

* ``*_hit_t`` — [rays, prims] nearest-forward-hit parameter matrices
  (misses are +inf), written over per-component [N, P] planes so the whole
  test is elementwise and fuses into the caller's argmin.
* ``*_surface`` — per-ray recompute of (t, point, normal, uv) for one already
  chosen primitive. The discrete nearest-hit *search* is non-differentiable
  by construction (indices); gradients flow through this analytic recompute
  only. This is the VJP boundary SURVEY.md §7 prescribes.

Forward-hit semantics match the reference's FORWARD filter, ``t >= 0``, first
of the (near, far) pair (intersection.ts:207-216, entity_sphere.ts:68-88,
entity_box.ts:54-73). Ray-triangle intersection (Moeller-Trumbore) is new
capability — the reference's triangle entity is an empty stub
(entities/entity_face.ts:17).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .vecmath import cross, dot, normalize, uv_map_sphere

Array = jnp.ndarray

INF = jnp.inf
#: determinant cutoff for Moeller-Trumbore parallel rays
MT_EPS = 1e-9


def _first_forward(t_near: Array, t_far: Array, valid: Array) -> Array:
    """First parameter >= 0 of an ordered (near, far) pair, else +inf.

    Mirrors select_parameters(FORWARD) + take-first
    (intersection.ts:207-216 used at entity_sphere.ts:72-77).
    """
    t = jnp.where(t_near >= 0.0, t_near, jnp.where(t_far >= 0.0, t_far, INF))
    return jnp.where(valid, t, INF)


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def _planes(org: Array, dir: Array):
    """[N, 3] rays -> six [N, 1] component columns (ox, oy, oz, dx, dy, dz)."""
    return tuple(v[:, i:i + 1] for v in (org, dir) for i in range(3))


def sphere_hit_t(org: Array, dir: Array, center: Array, radius: Array) -> Array:
    """Nearest forward hit params for [N] rays x [S] spheres -> [N, S].

    Quadratic-discriminant test (intersection.ts:109-128) written per xyz
    component over [N, S] planes: elementwise math that XLA fuses into the
    caller's min/argmin, with no [N, S, 3] intermediate. The fused kernel
    (kernels/trace_fused) evaluates the same expression term for term.
    """
    if center.shape[0] == 0:
        return jnp.full((org.shape[0], 0), INF, org.dtype)
    ox, oy, oz, dx, dy, dz = _planes(org, dir)
    ocx = ox - center[None, :, 0]
    ocy = oy - center[None, :, 1]
    ocz = oz - center[None, :, 2]
    a = dx * dx + dy * dy + dz * dz                 # [N, 1]
    inv_a = 1.0 / a
    b_half = ocx * dx + ocy * dy + ocz * dz         # dot(org - c, dir)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - (radius ** 2)[None, :]
    disc = b_half * b_half - a * c
    valid = disc >= 0.0
    sq = jnp.sqrt(jnp.where(valid, disc, 0.0))
    t_near = (-b_half - sq) * inv_a
    t_far = (-b_half + sq) * inv_a
    return _first_forward(t_near, t_far, valid)


def sphere_surface(org: Array, dir: Array, center: Array, radius: Array):
    """Differentiable (t, point, normal, uv) for one chosen sphere per ray.

    ``center``/``radius`` are already gathered per ray ([N,3]/[N]).
    Normal = (p - c)/r sign-flipped against the incoming direction so the
    inside-a-sphere view works (entity_sphere.ts:80-88). UV is the equirect
    map of (p - c) (entity_sphere.ts:98-101).
    """
    oc = org - center
    b_half = dot(oc, dir)
    a = dot(dir, dir)
    c = dot(oc, oc) - radius ** 2
    disc = b_half * b_half - a * c
    # Grad-safe sqrt: masked miss lanes (disc <= 0) keep a finite partial
    # so they cannot NaN-poison scene-parameter gradients through the
    # zero-cotangent chain rule.
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0)) * pos
    t_near = (-b_half - sq) / a
    t_far = (-b_half + sq) / a
    t = jnp.where(t_near >= 0.0, t_near, t_far)
    point = org + t[..., None] * dir
    # eps-guarded divisor: with the unified per-prim row table, non-sphere
    # rows reach this math with radius == 0 — an unguarded 1/r would put an
    # inf in the local derivative that NaN-poisons masked-lane gradients
    # (0 * inf) through the chain rule. Real radii are far above the guard.
    r_safe = jnp.where(jnp.abs(radius) < 1e-12, 1e-12, radius)
    normal = (point - center) / r_safe[..., None]
    normal = jnp.where(dot(dir, normal)[..., None] > 0.0, -normal, normal)
    u, v = uv_map_sphere(point - center)
    return t, point, normal, (u, v)


# ---------------------------------------------------------------------------
# Axis-aligned boxes
# ---------------------------------------------------------------------------

#: |dir| floor for the slab test: an axis-parallel ray divides by this
#: instead of 0, turning the reference's isNegative ±0 branch structure
#: (intersection.ts:150-204) into plain arithmetic with finite gradients.
SLAB_DIR_EPS = 1e-12


def _slab(org: Array, dir: Array, lo: Array, hi: Array):
    """Liang-Barsky slab intervals. Broadcasts to [..., 3] and reduces.

    Returns (t_enter, t_exit, enter_axis, exit_axis). Rays parallel to a
    slab get a clamped 1/eps instead of an inf: inside the slab the interval
    becomes (-huge, +huge) (no constraint), outside it becomes (huge, huge)
    (miss) — the same outcomes the reference reaches via its
    isNegative-based branches (intersection.ts:150-204) — while every
    partial derivative stays finite for masked-lane autodiff.
    """
    d_safe = jnp.where(jnp.abs(dir) < SLAB_DIR_EPS,
                       jnp.where(dir < 0, -SLAB_DIR_EPS, SLAB_DIR_EPS), dir)
    inv = 1.0 / d_safe
    ta = (lo - org) * inv
    tb = (hi - org) * inv
    t0 = jnp.minimum(ta, tb)
    t1 = jnp.maximum(ta, tb)
    t_enter = jnp.max(t0, axis=-1)
    t_exit = jnp.min(t1, axis=-1)
    enter_axis = jnp.argmax(t0, axis=-1)
    exit_axis = jnp.argmin(t1, axis=-1)
    return t_enter, t_exit, enter_axis, exit_axis


def box_hit_t(org: Array, dir: Array, center: Array, half: Array) -> Array:
    """Nearest forward hit params for [N] rays x [B] boxes -> [N, B].

    6-slab test (intersection.ts:150-204) over [N, B] component planes.
    ``u1 > u2`` is a miss; the equality (corner graze) is a hit, as in the
    reference (:193).
    """
    if center.shape[0] == 0:
        return jnp.full((org.shape[0], 0), INF, org.dtype)
    planes = _planes(org, dir)
    lo = (center - half).T                          # [3, B]
    hi = (center + half).T
    t0, t1 = [], []
    for i in range(3):
        o, d = planes[i], planes[3 + i]
        d_safe = jnp.where(jnp.abs(d) < SLAB_DIR_EPS,
                           jnp.where(d < 0, -SLAB_DIR_EPS, SLAB_DIR_EPS), d)
        inv = 1.0 / d_safe
        ta = (lo[i][None, :] - o) * inv
        tb = (hi[i][None, :] - o) * inv
        t0.append(jnp.minimum(ta, tb))
        t1.append(jnp.maximum(ta, tb))
    t_enter = jnp.maximum(jnp.maximum(t0[0], t0[1]), t0[2])
    t_exit = jnp.minimum(jnp.minimum(t1[0], t1[1]), t1[2])
    return _first_forward(t_enter, t_exit, t_enter <= t_exit)


def box_surface(org: Array, dir: Array, center: Array, half: Array):
    """Differentiable (t, point, normal, uv) for one chosen box per ray.

    Face normal comes from the winning slab axis (the FACE_NORMALS table of
    intersection.ts:141-148) flipped against the incoming direction
    (entity_box.ts:66-72); for an axis-aligned box that is always
    ``-sign(dir[axis]) * e_axis`` whether the ray enters or exits.

    UV implements the layout the reference *declares* but stubs out
    (entity_box.ts:104-107: "6:1 proportion, faces ordered left, right, top,
    bottom, front, back"): face f occupies u in [f/6, (f+1)/6).
    """
    lo = center - half
    hi = center + half
    t_enter, t_exit, enter_axis, exit_axis = _slab(org, dir, lo, hi)
    entering = t_enter >= 0.0
    t = jnp.where(entering, t_enter, t_exit)
    axis = jnp.where(entering, enter_axis, exit_axis)
    point = org + t[..., None] * dir
    ax_onehot = jax_onehot3(axis)
    # copysign-style: a ray with an exactly-zero component along the winning
    # axis (common on axis-aligned camera rows) must still get a unit normal
    # — jnp.sign would give 0 and a degenerate normal whose c1 = 0 poisons
    # downstream refraction gradients (oracle uses copysign with +1 at 0).
    d_axis = jnp.sum(dir * ax_onehot, axis=-1)
    sign = jnp.where(d_axis < 0.0, -1.0, 1.0)
    normal = -sign[..., None] * ax_onehot
    # face index in reference FACE_NORMALS order: (-x,+x,-y,+y,-z,+z).
    # The uv chain is f32 elementwise math on the ax_onehot planes: 0..5
    # face arithmetic and 0/1 selector dots are exact in f32.
    outward_sign = jnp.where(entering, -sign, sign)
    a0 = ax_onehot[..., 0]
    a1 = ax_onehot[..., 1]
    a2 = ax_onehot[..., 2]
    face = ((a1 + 2.0 * a2) * 2.0
            + jnp.where(outward_sign > 0.0, 1.0, 0.0))
    # local coords on the two non-axis dimensions. The divisor is
    # eps-guarded: unified-row callers feed non-box rows with zero half
    # widths whose masked lanes must stay NaN-free in primal AND gradient
    # (real boxes are unaffected). The axis picks are 0/1-weighted sums,
    # not take_along_axis, so the VJP stays elementwise.
    rel = jnp.clip((point - lo) / jnp.maximum(2.0 * half, 1e-12),
                   0.0, 1.0 - 2.0 ** -23)
    # b_axis one-hot = [a1+a2, a0, 0]; c_axis one-hot = [0, a2, a0+a1]
    u_local = rel[..., 0] * (a1 + a2) + rel[..., 1] * a0
    v_local = rel[..., 1] * a2 + rel[..., 2] * (a0 + a1)
    u = (face + u_local) / 6.0
    return t, point, normal, (u, v_local)


def jax_onehot3(axis: Array) -> Array:
    """One-hot over the trailing xyz axis."""
    return jnp.stack(
        [(axis == 0), (axis == 1), (axis == 2)], axis=-1
    ).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Triangles (new capability; reference stub entities/entity_face.ts:17)
# ---------------------------------------------------------------------------

def tri_hit_t(org: Array, dir: Array, v0: Array, v1: Array, v2: Array) -> Array:
    """Moeller-Trumbore for [N] rays x [T] triangles -> [N, T], over
    component planes."""
    if v0.shape[0] == 0:
        return jnp.full((org.shape[0], 0), INF, org.dtype)
    ox, oy, oz, dx, dy, dz = _planes(org, dir)
    e1x, e1y, e1z = (v1 - v0).T[:, None, :]
    e2x, e2y, e2z = (v2 - v0).T[:, None, :]
    v0x, v0y, v0z = v0.T[:, None, :]
    px = dy * e2z - dz * e2y                        # cross(d, e2)
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < MT_EPS, MT_EPS, det)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y                        # cross(s, e1)
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (jnp.abs(det) >= MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return jnp.where(valid, t, INF)


def tri_surface(org: Array, dir: Array, v0: Array, v1: Array, v2: Array):
    """Differentiable (t, point, normal, uv) for one chosen triangle per ray.

    Normal is the geometric normal flipped against the ray; uv are the
    barycentric (u, v).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(dir, e2)
    det = dot(e1, p)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < MT_EPS, MT_EPS, det)
    s = org - v0
    u = dot(s, p) * inv_det
    q = cross(s, e1)
    v = dot(dir, q) * inv_det
    t = dot(e2, q) * inv_det
    point = org + t[..., None] * dir
    normal = normalize(cross(e1, e2), eps=1e-20)
    normal = jnp.where(dot(dir, normal)[..., None] > 0.0, -normal, normal)
    return t, point, normal, (u, v)
