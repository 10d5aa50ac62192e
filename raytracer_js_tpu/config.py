"""Typed configuration records for the raytracer.

Mirrors the reference's plain config records (``RaytracerConfig``
/root/reference/src/raytracer.ts:33-43, ``CameraConfig``
/root/reference/src/view/camera.ts:27-45, walker/octree flags
/root/reference/src/octree_space.ts:154-156,
/root/reference/src/octree_entity.ts:81-90) as frozen dataclasses whose values
are *static* under ``jax.jit`` — they select code paths and shapes, never
traced values. Differentiable quantities (camera pose, material colors, entity
geometry) live in :mod:`raytracer_js_tpu.models.scene` pytrees instead.
"""
from __future__ import annotations

import dataclasses
import enum


class ResponseType(enum.IntEnum):
    """Material response taxonomy (reference /root/reference/src/material.ts:22-26).

    ``BOTH`` is declared but unhandled by the reference trace loop
    (raytracer.ts:250-251 default-returns); we reproduce that terminal
    behavior (ray keeps its current color) rather than the stub.
    """

    REFLECTION = 0
    TRANSMISSION = 1
    BOTH = 2


class RayStatus(enum.IntEnum):
    """Terminal state of a wavefront ray.

    The reference encodes these implicitly as control flow in ``Ray.trace()``
    (raytracer.ts:166-277); the wavefront formulation makes them an explicit
    per-ray i32 so every bounce is a fixed-shape masked update.

    * ``ALIVE``   — still bouncing.
    * ``LIGHT``   — hit an emissive material; inverse-square attenuation was
      applied (raytracer.ts:215-218, 273-275).
    * ``KEEP``    — terminated keeping its current color: non-mirror
      REFLECTION (raytracer.ts:222-225) or the unhandled BOTH response
      (raytracer.ts:250-251).
    * ``MISS``    — left the scene; color was modulated by the sky
      (raytracer.ts:267-271).
    * ``EXHAUST`` — bounce budget exceeded; color forced to black
      (raytracer.ts:256-263).
    """

    ALIVE = 0
    LIGHT = 1
    KEEP = 2
    MISS = 3
    EXHAUST = 4


class TextureKind(enum.IntEnum):
    SOLID = 0   # reference texture_solid.ts:21-44
    IMAGE = 1   # reference texture_image.ts:20-137 (nearest-neighbor)
    #: bilinear-filtered image — the reference's own TODO
    #: (texture_image.ts:52 "TODO: bilinear filtering"); capability beyond
    #: the reference, opt-in per texture (SceneBuilder.add_image_texture
    #: ``bilinear=True``)
    IMAGE_BILINEAR = 2


class ToneMapperKind(enum.IntEnum):
    """Tone mapping strategies (reference /root/reference/src/view/tone_mapping.ts:21-79)."""

    IDENTITY = 0
    STDDEV_AROUND_MEAN = 1
    ABSDEV_AROUND_MEAN = 2
    #: fixed [min_dynamic * 2^k, min_dynamic]-style window without stats
    #: (reference DynamicRangeLimitedToneMapper, tone_mapping.ts:35-46)
    DR_LIMITED = 3


class HitBackend(enum.Enum):
    """Nearest-hit search backend.

    * ``BRUTE``  — dense [rays, prims] intersection + argmin, elementwise
      math that XLA fuses into the reduction; small and medium scenes, and
      the differentiable path.
    * ``OCTREE`` — per-level Morton-grid DDA over the CSR octree (the
      wavefront re-expression of the reference's pointer walker,
      octree_space.ts:159-408); big scenes.
    * ``FUSED`` — whole-trace Pallas kernel through Triton (ray state in
      registers across bounces, kernels/trace_fused); solid textures and
      sky, no BOTH (kernels/trace_fused.supports); forward only. Scenes
      outside that class render on BRUTE.
    """

    BRUTE = "brute"
    OCTREE = "octree"
    FUSED = "fused"


# Epsilon the reference advances a respawned ray by to escape the previous
# collision point (raytracer.ts:158-164).
EPS_ADVANCE = 1e-3
# JS Number.EPSILON, used in the inverse-square-law denominator
# (raytracer.ts:274) and the equirect UV clamp (uv_mapping.ts:19-25).
JS_EPSILON = 2.0 ** -52


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (reference RaytracerConfig, raytracer.ts:33-43).

    ``refmax``/``distance_attenuation_factor`` match the reference semantics;
    everything else is new capability (sampling, backend choice).
    """

    refmax: int = 4
    distance_attenuation_factor: float = 1.0
    #: samples per pixel per call (Monte-Carlo scatter averaging inside one
    #: kernel launch; the reference instead averages frames over time,
    #: exposure_buffer.ts:53-91).
    spp: int = 1
    backend: HitBackend = HitBackend.BRUTE
    #: genuine ``ResponseType.BOTH`` (EXTENSION): stochastic Fresnel split
    #: — each BOTH hit continues as the reflected OR refracted ray with
    #: Schlick probability drawn from the (seed, ray id, bounce) counter
    #: RNG (single-sample unbiased; average over frames/spp like rough
    #: scatter). False reproduces the reference's terminal default
    #: (material.ts:25 declared, raytracer.ts:250-251 default-returns).
    fresnel_both: bool = False
    #: unroll the bounce fori_loop. Unrolling lets XLA fuse across bounces
    #: but multiplies the compiled graph by refmax.
    unroll: bool = False
    #: rematerialize each bounce in the VJP (jax.checkpoint, with flat
    #: loop carries) instead of saving its residuals: big wavefronts over
    #: big prim tables otherwise save residuals of rays x prims size.
    #: Gradients are identical either way
    #: (tests/test_grad.test_remat_gradients_match).
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class OctreeConfig:
    """Octree build parameters.

    ``max_depth`` plays the role of the reference's ``max_in_depth``
    (octree_entity.ts:81-90); outward re-rooting (octree_entity.ts:125-171)
    does not exist here because the root AABB is chosen up front to cover the
    scene — re-rooting a static SoA tree is a rebuild with a larger root.
    """

    max_depth: int = 4
    #: maximum entities per node after CSR padding; nodes beyond this raise
    #: at build time (analogue of the reference's TreeOutsideGrowError being
    #: a typed, recoverable build failure, octree_entity.ts:116-123).
    max_entities_per_node: int = 64


@dataclasses.dataclass(frozen=True)
class ToneMapConfig:
    """Dynamic-range windowing (reference tone_mapping.ts:35-79)."""

    kind: ToneMapperKind = ToneMapperKind.IDENTITY
    #: log2 of the dynamic range span (reference ``dynamic_range`` with
    #: ``dynamic_coef = 1 << dynamic_range``, tone_mapping.ts:40).
    dynamic_range: int = 8
    min_dynamic: float = 1e-4
    max_dynamic: float = 1e4
