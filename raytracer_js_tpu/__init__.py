"""raytracer_js_tpu — a differentiable raytracing framework in JAX.

Brand-new JAX/XLA/Pallas re-design with the capabilities of the reference
engine Dark565/raytracer.js (browser TypeScript CPU raytracer with a dynamic
octree): camera ray generation, octree-accelerated nearest-hit search,
reflection/refraction/scatter shading with sky fallback and inverse-square
light attenuation, progressive exposure accumulation, and tone mapping —
plus new capability: batched wavefront tracing, a Pallas (Triton) kernel,
multi-device sharding, and end-to-end differentiability for inverse rendering.
"""
from .config import (
    HitBackend,
    OctreeConfig,
    RenderConfig,
    ResponseType,
    RayStatus,
    TextureKind,
    ToneMapConfig,
    ToneMapperKind,
)
from .models.camera import Camera, make_camera, pixel_rays
from .models.scene import Scene, SceneBuilder
from .render import render, render_hdr

__all__ = [
    "Camera",
    "HitBackend",
    "OctreeConfig",
    "RenderConfig",
    "ResponseType",
    "RayStatus",
    "Scene",
    "SceneBuilder",
    "TextureKind",
    "ToneMapConfig",
    "ToneMapperKind",
    "make_camera",
    "pixel_rays",
    "render",
    "render_hdr",
]

__version__ = "0.1.0"
