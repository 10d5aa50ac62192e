"""Ray-space sharding over a device mesh (shard_map + XLA collectives).

The scaling design prescribed by SURVEY.md §2/§5 for this
workload: rays are independent, so the ONLY parallel axis is the pixel/ray
stream — tiles of rays sharded across devices, scene/materials/textures
replicated, zero inter-device communication in the forward pass, and one
``psum`` all-reduce of scene-parameter gradients in the backward (the
inverse-rendering fit). The reference has no analogue (single JS thread,
``for (let campx of ...)`` — raytracer.ts:318-329).

Determinism under sharding: each ray's RNG stream is keyed by its *global*
ray id (ops/sampling counter hash), so any mesh shape produces bitwise-identical
images.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..config import RenderConfig
from ..models.camera import Camera, pixel_rays
from ..models.scene import Scene
from ..render import render_rays

Array = jnp.ndarray

#: name of the single mesh axis rays are sharded over. With multi-host
#: meshes this axis simply spans all devices of all hosts; rays
#: never communicate, so no finer factorization is needed.
RAY_AXIS = "rays"


def make_mesh(devices: Optional[Sequence] = None, axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _ray_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(RAY_AXIS))


def render_rays_sharded(mesh: Mesh, scene: Scene, cfg: RenderConfig,
                        org: Array, dir: Array, key: Array,
                        ray_id: Array) -> Array:
    """Shard a flat wavefront over the mesh -> [N, 3] colors.

    Scene replicated (in_specs P()), rays split on the leading axis; the
    forward pass needs zero collectives.
    """
    n = org.shape[0]
    n_dev = mesh.devices.size
    assert n % n_dev == 0, (
        f"ray count {n} must divide over {n_dev} devices; pad the wavefront")

    fn = shard_map(
        lambda sc, o, d, rid: render_rays(sc, cfg, o, d, key, rid),
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
    )
    return fn(scene, org, dir, ray_id)


def render_hdr_sharded(mesh: Mesh, scene: Scene, camera: Camera,
                       cfg: RenderConfig,
                       key: Optional[Array] = None) -> Array:
    """Full-frame sharded render -> [h, w, 3] HDR (bitwise equal to the
    single-chip render_hdr for any mesh size)."""
    if key is None:
        key = jax.random.key(0)
    org, dirs = pixel_rays(camera)
    ray_id = jnp.arange(org.shape[0], dtype=jnp.int32)
    colors = render_rays_sharded(mesh, scene, cfg, org, dirs, key, ray_id)
    return colors.reshape(camera.h, camera.w, 3)


# ---------------------------------------------------------------------------
# Differentiable-parameter partition
# ---------------------------------------------------------------------------

def float_partition(scene: Scene):
    """Split a Scene pytree into (params, rebuild).

    ``params`` is the list of inexact (float) leaves — the differentiable
    degrees of freedom (sphere centers/radii, box geometry, triangle
    vertices, solid/atlas texture colors, material roughness, refractive
    indices); ``rebuild(params)`` reassembles a Scene around them. Integer
    id columns stay static.
    """
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    is_f = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.inexact) for l in leaves]
    params = [l for l, f in zip(leaves, is_f) if f]

    def rebuild(new_params):
        it = iter(new_params)
        merged = [next(it) if f else l for l, f in zip(leaves, is_f)]
        return jax.tree_util.tree_unflatten(treedef, merged)

    return params, rebuild


# ---------------------------------------------------------------------------
# Sharded inverse-rendering step
# ---------------------------------------------------------------------------

def sharded_fit_step(mesh: Mesh, scene: Scene, cfg: RenderConfig,
                     camera: Camera, target: Array, key: Array):
    """One data-parallel inverse-rendering step -> (loss, grads).

    Pixel L2 loss against ``target`` ([N, 3] flat). Each device renders its
    ray shard and differentiates the *local* loss contribution wrt the
    (replicated) scene parameters; a single ``psum`` over the ray axis
    all-reduces both loss and gradients — XLA hands the collective to NCCL
    (NVLink within a host, the network across hosts), overlapped with the backward tail by XLA's
    latency-hiding scheduler (SURVEY.md §5 "Distributed communication").

    ``grads`` matches the pytree returned by :func:`float_partition`.
    """
    org, dirs = pixel_rays(camera)
    n = org.shape[0]
    ray_id = jnp.arange(n, dtype=jnp.int32)
    params, rebuild = float_partition(scene)

    def local_loss(params, o, d, rid, tgt):
        sc = rebuild(params)
        colors = render_rays(sc, cfg, o, d, key, rid)
        return jnp.sum((colors - tgt) ** 2) / n

    def step(params, o, d, rid, tgt):
        loss, grads = jax.value_and_grad(local_loss)(params, o, d, rid, tgt)
        loss = jax.lax.psum(loss, RAY_AXIS)
        # NOTE: no explicit psum on grads — params enter the shard as
        # replicated (unvarying) values, and JAX's varying-axis transpose
        # already all-reduces their cotangents (the pvary transpose IS psum),
        # returning replicated, globally-summed gradients. An explicit psum
        # here would double-count by the device factor.
        return loss, grads

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)(params, org, dirs, ray_id, target)
