"""Counter-based random sampling for scatter.

Re-design of the reference RNG stack (reference src/math/rng/):
the single sequential ``FpLcg`` stream (fp-lcg.ts:50-83) cannot exist in a
data-parallel wavefront — every ray would contend for one state. Instead
every draw is a pure function of ``(seed, global ray id, bounce, salt)``
through a chained 32-bit avalanche hash (lowbias32), which is
order-independent and therefore reproducible under ANY sharding of the ray
space (SURVEY.md §2 #7): a ray's random stream depends only on its global
pixel id, never on which chip traces it.

Why an explicit hash instead of ``jax.random`` threefry keys (the r1
design): the hash is plain elementwise uint32/f32 arithmetic, so the SAME
functions execute unchanged inside Pallas kernel bodies — the fused
whole-trace kernel draws identical scatter directions to the XLA wavefront
path (golden parity for rough scenes at fused-kernel tolerance), where
threefry key folding + ``jax.random.normal``'s erfinv bit paths could not
be reproduced in-kernel. ``lowbias32`` uses constant shifts only.

The unit-ball direction sample replaces the reference's rejection loop
(vector_utils.ts:8-14, ~pi/6 acceptance — unvectorizable) with the exact
branch-free polar construction: z uniform in [-1, 1], azimuth uniform,
radius cube-root-of-uniform. Same uniform-in-ball distribution
(tests/test_sampling_stats.py: radial CDF + isotropy checks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .vecmath import dot, normalize

Array = jnp.ndarray

_TWO_PI = float(2.0 * np.pi)
#: salts decorrelating the per-(ray, bounce) draws
SALT_Z, SALT_PHI, SALT_R = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
#: Fresnel reflect-vs-refract choice for ResponseType.BOTH (extension)
SALT_FRESNEL = 0x27D4EB2F


def seed_from_key(key: Array) -> Array:
    """Fold a jax PRNG key into the uint32 stream seed.

    The public API (render_hdr / trace_rays / fit) speaks jax keys; the
    trace internals speak this counter seed.
    """
    return jax.random.bits(key, (), jnp.uint32)


def lowbias32(x: Array) -> Array:
    """Wellons' lowbias32 avalanche hash — constant-shift, kernel-safe."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(seed: Array, rid: Array, bounce: Array, salt: int) -> Array:
    """Chained hash of the draw coordinates -> uint32 bits.

    Elementwise over broadcasting ``rid``/``bounce``; every input change
    avalanches through two lowbias32 rounds.
    """
    h = lowbias32(jnp.asarray(rid).astype(jnp.uint32)
                  ^ jnp.asarray(seed, jnp.uint32))
    h = lowbias32(h + jnp.asarray(bounce).astype(jnp.uint32)
                  * jnp.uint32(0x68BC21EB))
    return lowbias32(h ^ jnp.uint32(salt))


def uniform01(bits: Array) -> Array:
    """uint32 bits -> f32 uniform in [0, 1) (24-bit mantissa path).

    The high 24 bits go through int32 (exact below 2^24), the same
    conversion inside the kernel and in XLA.
    """
    return ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
            * jnp.float32(1.0 / (1 << 24)))


def ray_uniform(seed: Array, rid: Array, bounce: Array, salt: int) -> Array:
    return uniform01(hash_u32(seed, rid, bounce, salt))


def ball_sample_xyz(seed: Array, rid: Array, bounce: Array):
    """Uniform-in-ball sample as elementwise (x, y, z) planes.

    Shape-polymorphic (works on [N] wavefronts and [SUB, LANE] kernel
    tiles). Polar construction: direction from (z, phi) uniform on the
    sphere, radius = cbrt(uniform).
    """
    z = 1.0 - 2.0 * ray_uniform(seed, rid, bounce, SALT_Z)
    phi = _TWO_PI * ray_uniform(seed, rid, bounce, SALT_PHI)
    u_r = ray_uniform(seed, rid, bounce, SALT_R)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    # cbrt via exp/log; u_r floored away from 0 (r(2^-25) ~ 3e-3)
    r = jnp.exp(jnp.log(jnp.maximum(u_r, 2.0 ** -25)) * (1.0 / 3.0))
    return r * s * jnp.cos(phi), r * s * jnp.sin(phi), r * z


def scatter_direction_xyz(seed: Array, rid: Array, bounce: Array,
                          rx: Array, ry: Array, rz: Array,
                          nx: Array, ny: Array, nz: Array, rho: Array,
                          div=jnp.divide):
    """Roughness-lerped scatter (raytracer.ts:121-133), elementwise planes:
    ``normalize((1 - rho) * reflected + rho * ball_sample_in_hemisphere)``,
    with the ball sample flipped into the hemisphere of the normal
    (raytracer.ts:121-127) and roughness 0 returning exactly ``reflected``
    (the draw has no effect there — deterministic golden tests).
    ``div`` lets a kernel supply its own correctly rounded division."""
    bx, by, bz = ball_sample_xyz(seed, rid, bounce)
    flip = jnp.where(bx * nx + by * ny + bz * nz < 0.0, -1.0, 1.0)
    bx, by, bz = bx * flip, by * flip, bz * flip
    mx = (1.0 - rho) * rx + rho * bx
    my = (1.0 - rho) * ry + rho * by
    mz = (1.0 - rho) * rz + rho * bz
    inv = div(1.0, jnp.sqrt(jnp.maximum(mx * mx + my * my + mz * mz, 1e-20)))
    rough = rho > 0.0
    return (jnp.where(rough, mx * inv, rx),
            jnp.where(rough, my * inv, ry),
            jnp.where(rough, mz * inv, rz))


# ---------------------------------------------------------------------------
# [N, 3] wavefront wrappers (the ops/trace + test surface)
# ---------------------------------------------------------------------------

def ball_sample(seed: Array, rid: Array, bounce: Array | int = 0) -> Array:
    """Uniform samples in the unit ball -> [N, 3]."""
    x, y, z = ball_sample_xyz(seed, rid, jnp.asarray(bounce))
    return jnp.stack([x, y, z], axis=-1)


def hemisphere_ball_sample(seed: Array, rid: Array, normal: Array,
                           bounce: Array | int = 0) -> Array:
    """Unit-ball sample flipped into the hemisphere of ``normal``
    (the scatter setup of raytracer.ts:121-127)."""
    v = ball_sample(seed, rid, bounce)
    flip = dot(v, normal) < 0.0
    return jnp.where(flip[..., None], -v, v)


def scatter_direction(seed: Array, rid: Array, bounce: Array | int,
                      reflected: Array, normal: Array,
                      roughness: Array) -> Array:
    """[N, 3] wrapper over :func:`scatter_direction_xyz`."""
    b = jnp.asarray(bounce)
    x, y, z = scatter_direction_xyz(
        seed, rid, b,
        reflected[..., 0], reflected[..., 1], reflected[..., 2],
        normal[..., 0], normal[..., 1], normal[..., 2], roughness)
    return jnp.stack([x, y, z], axis=-1)
