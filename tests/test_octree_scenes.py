"""OCTREE frames vs BRUTE on the scene classes the big-scene path serves.

The octree DDA (accel/octree.nearest_hit_octree) must pick the same winners
as the dense search: sphere fields, boxes, triangle meshes, image textures,
bilinear filtering and a cube-map sky, across octree depths. Exact
nearest-hit ties may resolve to a different primitive on isolated pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import RenderConfig, ResponseType, SceneBuilder, make_camera
from raytracer_js_tpu.accel.octree import build_octree
from raytracer_js_tpu.config import HitBackend, OctreeConfig
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops.trace import record_paths, trace_rays
from raytracer_js_tpu.render import render_hdr

W, H = 128, 32


def _tiny_scene(seed=2):
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(4)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])   # ground
    for i in range(7):
        c = rng.uniform([2.5, -3.0, -0.3], [8.0, 3.0, 3.0], 3)
        b.add_sphere(c, float(rng.uniform(0.3, 0.8)),
                     mirror if i % 2 == 0 else diffuse, pal[i % 4])
    b.add_sphere((5.0, 0.0, 5.0), 1.0, light, pal[1])
    return b.build()


def _sphere_field(seed, n=700):
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(6)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])
    for i in range(n):
        c = rng.uniform([2.0, -4.0, -0.5], [10.0, 4.0, 4.0], 3)
        b.add_sphere(c, float(rng.uniform(0.05, 0.2)),
                     mirror if i % 3 == 0 else diffuse, pal[i % 6])
    return b.build()


def _camera(w=W, h=H):
    return make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2, np.pi / 2 * h / w)


def _check_octree(scene, depth, refmax=2, cam=None):
    cam = cam or _camera()
    accel = build_octree(scene, OctreeConfig(max_depth=depth))
    want = np.asarray(render_hdr(scene, cam, RenderConfig(refmax=refmax)))
    got = np.asarray(render_hdr(
        scene, cam, RenderConfig(refmax=refmax, backend=HitBackend.OCTREE),
        accel=accel))
    assert np.isfinite(got).all()
    mism = (~np.isclose(got, want, rtol=1e-4, atol=1e-5)).any(axis=-1)
    assert mism.mean() < 0.002, f"{mism.sum()} mismatching pixels"


@pytest.mark.parametrize("depth", [3, 5])
def test_octree_tiny_scene_matches_brute(depth):
    _check_octree(_tiny_scene(), depth)


@pytest.mark.parametrize("backend", [HitBackend.OCTREE, HitBackend.BRUTE])
def test_record_replays_frame(backend):
    """A recording (pid_seq) from either search, replayed differentiably by
    trace_rays, reproduces the frame — the fit's record + replay path."""
    scene = _tiny_scene()
    cam = _camera()
    cfg = RenderConfig(refmax=2, backend=backend)
    accel = build_octree(scene, OctreeConfig(max_depth=4))
    want = np.asarray(render_hdr(scene, cam, cfg, accel=accel))
    org, dirs = pixel_rays(cam)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    key = jax.random.key(0)
    rec = record_paths(scene, cfg, org, dirs, key, rid, accel=accel)
    assert rec.shape == (cam.h * cam.w, cfg.refmax)
    st = trace_rays(scene, cfg, org, dirs, key, rid, pid_seq=rec)
    np.testing.assert_allclose(
        np.asarray(st.color).reshape(cam.h, cam.w, 3), want,
        rtol=1e-4, atol=1e-5)


def test_octree_skybox_and_bilinear():
    """Cube-map sky + bilinear image textures shade the same on OCTREE."""
    rng = np.random.default_rng(3)
    b = SceneBuilder(atlas_hw=(8, 8))
    faces = [b.add_solid_texture(c) for c in
             ((1, 0, 0), (0, 1, 0), (0, 0, 1),
              (1, 1, 0), (1, 0, 1), (0, 1, 1))]
    b.set_sky_box(faces)
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    tex = b.add_image_texture(
        rng.uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32), bilinear=True)
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, tex)
    b.add_sphere((4.0, 0.0, 0.5), 1.2, mirror,
                 b.add_solid_texture((0.9, 0.9, 0.9)))
    _check_octree(b.build(), 4)


def test_octree_many_small_spheres():
    _check_octree(_sphere_field(11), 5)


def test_octree_deep_grid_many_spheres():
    """A depth-7 grid: most spheres span one fine cell, the DDA marches
    long runs of empty cells."""
    _check_octree(_sphere_field(13), 7)


def test_octree_triangle_mesh():
    """A 1280-triangle icosphere mirror: tri winners through the octree."""
    from raytracer_js_tpu.utils.mesh import icosphere

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse,
              b.add_solid_texture((0.5, 0.5, 0.5)))
    v, f = icosphere(3, radius=1.2, center=(5.0, 0.0, 1.0))
    b.add_mesh(v, f, mirror, b.add_solid_texture((0.9, 0.75, 0.3)))
    b.add_sphere((4.0, -2.0, 0.5), 0.7, diffuse,
                 b.add_solid_texture((0.8, 0.2, 0.2)))
    scene = b.build()
    assert scene.n_tris >= 512
    _check_octree(scene, 5)


def test_octree_image_scene_matches_brute():
    """Image-textured spheres and triangle, image sky, 3 bounces."""
    b = SceneBuilder(atlas_hw=(16, 16))
    yy = np.linspace(0.0, 1.0, 16)[:, None] * np.ones((1, 16))
    sky_img = np.stack([0.3 + 0.3 * yy, 0.4 + 0.2 * yy,
                        0.6 + 0.2 * yy], -1).astype(np.float32)
    b.set_sky(b.add_image_texture(sky_img))
    check = (np.indices((16, 16)).sum(0) % 2).astype(np.float32)[..., None]
    checker = (check * [0.5, 0.1, 0.1] + [0.3, 0.3, 0.3]).astype(np.float32)
    tex_check = b.add_image_texture(checker)
    grey = b.add_solid_texture((0.55, 0.55, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_sphere((4.0, -1.2, 0.6), 0.8, mirror, white)
    b.add_sphere((4.0, 1.4, 0.7), 0.9, diffuse, tex_check)
    b.add_sphere((6.0, 1.0, 5.0), 1.2, light, white)
    b.add_triangle((3.0, -0.8, -0.4), (3.6, 0.4, 1.3), (4.2, -1.6, 1.0),
                   diffuse, tex_check)
    _check_octree(b.build(), 4, refmax=3, cam=_camera(32, 24))
