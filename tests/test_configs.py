"""BASELINE config-class parity tests (scaled-down resolutions so the scalar
oracle stays tractable; scene complexity matches the config definitions).

Config 2: 50 random spheres, diffuse+specular, 2 bounces, depth-4 octree.
Config 3: triangle mesh + spheres, textured + sky gradient, 3 bounces.
"""
import numpy as np
import pytest

from raytracer_js_tpu import (
    RenderConfig,
    ResponseType,
    SceneBuilder,
    make_camera,
    render_hdr,
)
from raytracer_js_tpu.accel.octree import build_octree
from raytracer_js_tpu.config import HitBackend, OctreeConfig
from raytracer_js_tpu.oracle import scalar as oracle
from raytracer_js_tpu.utils.mesh import icosphere, mesh_stats


def config2_scene(n=50, seed=7):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.7)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0, 0, -52.0), 100.0, diffuse, b.add_solid_texture((0.6, 0.6, 0.6)))
    for i in range(n):
        c = rng.uniform([2, -6, -1.5], [14, 6, 5])
        r = float(rng.uniform(0.15, 0.7))
        tex = b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
        b.add_sphere(c, r, mirror if i % 3 == 0 else diffuse, tex)
    b.add_sphere((8.0, 0.0, 6.0), 1.0, light, b.add_solid_texture((1, 1, 1)))
    return b.build()


def config3_scene(subdiv=1, seed=9):
    """Textured mesh + spheres + gradient-ish sky (image texture)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(atlas_hw=(32, 32))
    # vertical sky gradient as an image texture (the "sky gradient")
    grad = np.linspace(0.9, 0.2, 32)[:, None, None] * np.array([0.5, 0.7, 1.0])
    sky = b.add_image_texture(np.broadcast_to(grad, (32, 32, 3)))
    b.set_sky(sky)
    checker = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    tex_img = b.add_image_texture(np.stack([checker, 1 - checker, checker], -1))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    v, f = icosphere(subdiv, radius=1.2, center=(5.0, 0.0, 0.5))
    b.add_mesh(v, f, diffuse, tex_img)
    b.add_sphere((4.0, 2.0, 0.2), 0.8, mirror, b.add_solid_texture((1, 1, 1)))
    b.add_sphere((4.0, -2.0, 0.2), 0.8, diffuse, b.add_solid_texture((0.8, 0.3, 0.2)))
    return b.build()


def test_config2_matches_oracle_and_octree():
    scene = config2_scene()
    cam = make_camera((0, 0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=2)
    img = np.asarray(render_hdr(scene, cam, cfg))
    ref = oracle.render(scene, cam, cfg)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    accel = build_octree(scene, OctreeConfig(max_depth=4))
    img_o = np.asarray(render_hdr(
        scene, cam, RenderConfig(refmax=2, backend=HitBackend.OCTREE),
        accel=accel))
    np.testing.assert_allclose(img_o, img, rtol=1e-5, atol=1e-6)


def test_config3_mesh_matches_oracle():
    scene = config3_scene(subdiv=1)   # 80 triangles; oracle-tractable
    assert scene.n_tris == 80
    cam = make_camera((0, 0, 0.5), 20, 20, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=3)
    img = np.asarray(render_hdr(scene, cam, cfg))
    ref = oracle.render(scene, cam, cfg)
    # Image textures quantize UV to texel indices; float32 vs float64
    # (oracle) geometry flips the index on a few texel-boundary pixels.
    # Those pixels differ by at most one texel step; everything else must
    # hold the golden 1e-4 contract.
    err = np.abs(img - ref).max(axis=-1)
    frac_exact = (err <= 1e-4).mean()
    assert frac_exact >= 0.97, frac_exact
    assert err.max() <= 0.05, err.max()   # <= one gradient texel step


def test_config3_5k_mesh_renders_with_octree():
    """The full 5k-triangle mesh class: render via the octree backend
    (no oracle — just structural health: finite, sky visible, mesh hits)."""
    scene = config3_scene(subdiv=4)
    st = mesh_stats(*icosphere(4))
    assert st["n_tris"] == 5120 and scene.n_tris == 5120
    cam = make_camera((0, 0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    accel = build_octree(scene, OctreeConfig(max_depth=4))
    img = np.asarray(render_hdr(
        scene, cam, RenderConfig(refmax=2, backend=HitBackend.OCTREE),
        accel=accel))
    assert np.isfinite(img).all()
    brute = np.asarray(render_hdr(scene, cam, RenderConfig(refmax=2)))
    np.testing.assert_allclose(img, brute, rtol=1e-5, atol=1e-6)


def test_icosphere_is_spherical():
    v, f = icosphere(2, radius=2.0, center=(1.0, 0.0, 0.0))
    r = np.linalg.norm(v - np.array([1.0, 0.0, 0.0]), axis=1)
    np.testing.assert_allclose(r, 2.0, atol=1e-5)
