"""Batched 3-vector algebra on ``[..., 3]`` arrays.

Re-design of the reference's scalar vector module
(/root/reference/src/math/vector.ts): free functions over ``{v: number[]}``
records become broadcasting ``jnp`` ops over trailing-3 axes, so every ray in
a wavefront is one lane of the same instruction. The in-place ``*_self``
variants disappear (functional arrays); rotation helpers keep the reference's
Givens-pair semantics (vector.ts:318-323) because the camera is specified in
terms of them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def dot(a: Array, b: Array) -> Array:
    """Batched dot product (reference vector.ts:78-86). Returns [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: Array, b: Array) -> Array:
    """Batched 3D cross product (reference vector.ts:88-101)."""
    return jnp.cross(a, b)


def length(a: Array) -> Array:
    """Euclidean norm over the trailing axis (reference vector.ts length)."""
    return jnp.sqrt(dot(a, a))


def normalize(a: Array, eps: float = 0.0) -> Array:
    """Unit vector (reference vector.ts normalize). ``eps`` guards /0 for
    padded lanes (new: the reference would produce NaN). The guarded form
    uses ``rsqrt(|a|^2 + eps^2)`` so the *gradient* is also finite at 0 —
    required because masked-out wavefront lanes still flow through autodiff
    (0-cotangent times an inf partial is NaN)."""
    if eps:
        return a * jax.lax.rsqrt(dot(a, a) + eps * eps)[..., None]
    return a / length(a)[..., None]


def reflect(v: Array, normal: Array) -> Array:
    """Mirror reflection about a unit normal: ``v - 2*dot(v,n)*n``
    (reference vector.ts:263-268, used by raytracer.ts:117-119)."""
    return v - 2.0 * dot(v, normal)[..., None] * normal


def rotate_vectors(base_x: Array, base_y: Array, cos_a: Array, sin_a: Array):
    """Givens rotation of an orthogonal pair within their shared plane.

    Matches reference ``rotate_vectors`` (vector.ts:318-323) where the angle
    is carried as a normalized 2-vector ``(cos, sin)``:
    ``x' = cos*x + sin*y``, ``y' = -sin*x + cos*y``.
    """
    c = jnp.asarray(cos_a)[..., None]
    s = jnp.asarray(sin_a)[..., None]
    return c * base_x + s * base_y, -s * base_x + c * base_y


def ortho2(v: Array) -> Array:
    """2D perpendicular (reference vector.ts ortho): (x, y) -> (-y, x)."""
    return jnp.stack([-v[..., 1], v[..., 0]], axis=-1)


def refract(dir: Array, normal: Array, eta: Array):
    """Snell refraction with total-internal-reflection fallback.

    ``dir``/``normal`` unit, ``normal`` oriented *against* ``dir``
    (dot(dir, normal) <= 0, the reference's collision-normal convention,
    entity_sphere.ts:84, entity_box.ts:70). ``eta = n_from / n_to``.

    Returns ``(new_dir, tir_mask)``.

    DOCUMENTED DIVERGENCE from the reference: raytracer.ts:135-150 computes
    ``dir' = eta*dir - (cos_t - cos_raw)*normal`` with ``cos_raw = dot(d, n)``,
    which is not Snell's law for any normal orientation (it neither preserves
    the tangential component scaling nor unit length). This framework — and
    its scalar oracle, which defines the allclose contract — uses the standard
    form ``t = eta*d + (eta*c1 - c2)*n`` with ``c1 = -dot(d, n)``,
    ``c2 = sqrt(1 - eta^2*(1 - c1^2))``. The TIR branch (reflect) matches the
    reference (raytracer.ts:147-149).
    """
    eta = jnp.asarray(eta)
    c1 = -dot(dir, normal)
    s2 = (eta ** 2) * (1.0 - c1 ** 2)
    tir = s2 > 1.0
    # Grad-safe sqrt: at the TIR boundary (s2 == 1, e.g. grazing hits on
    # masked wavefront lanes) d(sqrt)/ds2 is infinite; a zero cotangent from
    # the un-selected branch times that inf would NaN-poison scene-parameter
    # gradients. Primal value is unchanged (c2 = 0 there).
    inside = jnp.clip(1.0 - s2, 0.0, None)
    pos = inside > 0.0
    c2 = jnp.sqrt(jnp.where(pos, inside, 1.0)) * pos
    refr = eta[..., None] * dir + (eta * c1 - c2)[..., None] * normal
    refl = reflect(dir, normal)
    return jnp.where(tir[..., None], refl, refr), tir


def uv_map_sphere(d: Array):
    """Direction -> equirectangular (u, v) in [0, 1).

    Matches reference uv_mapping.ts:19-25:
    ``u = atan2(y, x)/(2*pi) + 0.5 - eps``,
    ``v = atan2(z, |(x, y)|)/pi + 0.5 - eps``.
    """
    eps = 2.0 ** -52
    u = jnp.arctan2(d[..., 1], d[..., 0]) / (2.0 * jnp.pi) + 0.5 - eps
    xy = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    v = jnp.arctan2(d[..., 2], xy) / jnp.pi + 0.5 - eps
    return u, v
