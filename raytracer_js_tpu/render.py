"""Render frontend — the jitted ``render(scene, camera) -> image`` entry.

Re-design of ``Raytracer.trace_frame()`` (reference src/
raytracer.ts:281-339): the per-pixel Python loop becomes one wavefront of
``h*w`` rays traced in a single fused computation. The camera-position
substance lookup happens once per frame (raytracer.ts:312-313), exactly as in
the reference. Samples-per-pixel batching replaces the reference's
across-frames progressive averaging (it is the same running mean computed in
one launch; the cross-launch accumulator also exists, see view/exposure.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .config import HitBackend, RenderConfig
from .kernels import trace_fused
from .models.camera import Camera, pixel_rays
from .models.scene import Scene
from .ops import trace as trace_mod

Array = jnp.ndarray


def _stochastic(scene: Scene, cfg: RenderConfig) -> bool:
    """spp averaging only helps when some draw actually varies per sample:
    rough scatter, or the Fresnel-BOTH split (RenderConfig.fresnel_both)."""
    return scene.has_rough or (scene.has_both and cfg.fresnel_both)

def start_substance(scene: Scene, pos: Array) -> Array:
    """Substance at the camera position (raytracer.ts:312-313): innermost
    containing entity's substance, or the scene default."""
    refr, _ = trace_mod.substance_refr_at(
        scene, pos[None, :], scene.default_refr[None])
    return refr[0]


def render_rays(scene: Scene, cfg: RenderConfig, org: Array, dir: Array,
                key: Array, ray_id: Array, accel=None) -> Array:
    """Trace a flat wavefront, averaging ``cfg.spp`` samples -> [N, 3] HDR.

    Sample s of ray i uses the RNG stream (key, ray_id[i]*spp + s), so the
    result is bitwise identical under any device sharding of the wavefront.
    """
    if cfg.backend == HitBackend.FUSED:
        if trace_fused.supports(scene):
            # Whole bounce loop inside one kernel. Rough scenes draw from
            # the same (key, ray_id*spp + s, bounce) counter streams as the
            # XLA path below; deterministic scenes skip the spp loop
            # (averaging identical samples is a no-op).
            refr0 = (start_substance(scene, org[0])
                     if scene.has_transmission else None)

            def one_fused(s):
                color, _status = trace_fused.trace_rays_fused(
                    scene, cfg, org, dir, key=key,
                    ray_id=ray_id * cfg.spp + s, start_refr=refr0)
                return color

            if cfg.spp == 1 or not _stochastic(scene, cfg):
                return one_fused(0)
            acc = jax.lax.fori_loop(
                0, cfg.spp, lambda s, a: a + one_fused(s),
                jnp.zeros_like(org))
            return acc / cfg.spp
        # image textures, sky boxes and BOTH: the XLA path
        cfg = dataclasses.replace(cfg, backend=HitBackend.BRUTE)

    refr0 = jnp.broadcast_to(start_substance(scene, org[0]), (org.shape[0],))

    def one_sample(s):
        sid = ray_id * cfg.spp + s
        st = trace_mod.trace_rays(scene, cfg, org, dir, key, sid,
                                  start_refr=refr0, accel=accel)
        return st.color

    if cfg.spp == 1:
        return one_sample(0)

    def body(s, acc):
        return acc + one_sample(s)

    acc = jax.lax.fori_loop(0, cfg.spp, body, jnp.zeros_like(org))
    return acc / cfg.spp


def render_hdr(scene: Scene, camera: Camera, cfg: RenderConfig,
               key: Optional[Array] = None, accel=None) -> Array:
    """Full-frame HDR render -> [h, w, 3] float32 (linear, pre-tone-map).

    ``accel`` is the octree of the OCTREE backend (accel.octree.build_octree).
    """
    if key is None:
        key = jax.random.key(0)
    if cfg.backend == HitBackend.FUSED and trace_fused.supports(scene):
        # rays are generated inside the kernel: no ray tensors at all
        refr0 = (start_substance(scene, camera.pos)
                 if scene.has_transmission else None)

        def one_frame(s):
            return trace_fused.trace_frame_fused(
                scene, cfg, camera, key=key, sample=s, start_refr=refr0)

        if cfg.spp == 1 or not _stochastic(scene, cfg):
            return one_frame(0)
        acc = jax.lax.fori_loop(
            0, cfg.spp, lambda s, a: a + one_frame(s),
            jnp.zeros((camera.h, camera.w, 3), jnp.float32))
        return acc / cfg.spp
    org, dir = pixel_rays(camera)
    ray_id = jnp.arange(org.shape[0], dtype=jnp.int32)
    colors = render_rays(scene, cfg, org, dir, key, ray_id, accel=accel)
    return colors.reshape(camera.h, camera.w, 3)


# Convenience alias matching the package-level API.
render = render_hdr
