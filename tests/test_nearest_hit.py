"""BRUTE nearest-hit search vs a float64 NumPy nearest-hit.

The float32 search (ops/trace.nearest_hit_brute over the elementwise
ops/intersect hit tests) must pick the same winner as an independent
float64 evaluation of the same first-forward-hit rules, except at exact
ties, and must report no phantom hits on near-miss rays.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import ResponseType, SceneBuilder, make_camera, render_hdr
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.oracle import scalar as oracle
from raytracer_js_tpu.ops.intersect import MT_EPS, SLAB_DIR_EPS
from raytracer_js_tpu.ops.trace import nearest_hit_brute

from scenes import config1_camera, config1_cfg, config1_scene


def _first_forward(t_near, t_far, valid):
    t = np.where(t_near >= 0, t_near, np.where(t_far >= 0, t_far, np.inf))
    return np.where(valid, t, np.inf)


def nearest_hit_f64(scene, org, d):
    """(t [N], pid [N]) in float64 over [spheres | boxes | tris]."""
    o = np.asarray(org, np.float64)[:, None, :]
    d = np.asarray(d, np.float64)[:, None, :]
    parts = []
    c = np.asarray(scene.sphere_center, np.float64)[None]
    r = np.asarray(scene.sphere_radius, np.float64)[None]
    oc = o - c
    a = (d * d).sum(-1)
    b = (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - r ** 2
    disc = b * b - a * cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    parts.append(_first_forward((-b - sq) / a, (-b + sq) / a, disc >= 0))
    bc = np.asarray(scene.box_center, np.float64)[None]
    bh = np.asarray(scene.box_half, np.float64)[None]
    dd = np.where(np.abs(d) < SLAB_DIR_EPS,
                  np.where(d < 0, -SLAB_DIR_EPS, SLAB_DIR_EPS), d)
    ta, tb = (bc - bh - o) / dd, (bc + bh - o) / dd
    t_in = np.minimum(ta, tb).max(-1)
    t_out = np.maximum(ta, tb).min(-1)
    parts.append(_first_forward(t_in, t_out, t_in <= t_out))
    v0 = np.asarray(scene.tri_v0, np.float64)[None]
    e1 = np.asarray(scene.tri_v1, np.float64)[None] - v0
    e2 = np.asarray(scene.tri_v2, np.float64)[None] - v0
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) < MT_EPS, MT_EPS, det)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (np.abs(det) >= MT_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    parts.append(np.where(ok, t, np.inf))
    t_all = np.concatenate(parts, axis=1)
    pid = np.argmin(t_all, axis=1)
    t_min = t_all[np.arange(t_all.shape[0]), pid]
    return t_min, np.where(np.isfinite(t_min), pid, -1)


def _rand_rays(n, seed=0, lo=-6, hi=6):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def _assert_matches_f64(scene, org, d, max_tie_frac=0.0):
    t_b, p_b = map(np.asarray, nearest_hit_brute(scene, org, d))
    t_r, p_r = nearest_hit_f64(scene, org, d)
    # no phantom hits and no lost hits
    np.testing.assert_array_equal(p_b >= 0, p_r >= 0)
    hit = p_r >= 0
    np.testing.assert_allclose(t_b[hit], t_r[hit], rtol=1e-4, atol=1e-5)
    assert (p_b != p_r).mean() <= max_tie_frac
    return p_r


@pytest.mark.parametrize("with_glass,with_tri", [(False, False), (True, True)])
def test_brute_matches_f64(with_glass, with_tri):
    scene = config1_scene(with_glass=with_glass, with_tri=with_tri)
    org, d = _rand_rays(300, seed=1)
    p = _assert_matches_f64(scene, org, d, max_tie_frac=0.02)
    assert (p >= 0).any() and (p < 0).any()


def test_brute_odd_ray_count():
    """A ray count that is no power of two (37) round-trips."""
    scene = config1_scene()
    org, d = _rand_rays(37, seed=2)
    _assert_matches_f64(scene, org, d)


def test_render_brute_glass_tri_matches_oracle():
    scene = config1_scene(with_glass=True, with_tri=True)
    cam = config1_camera(16, 16)
    img = np.asarray(render_hdr(scene, cam, config1_cfg()))
    ref = oracle.render(scene, cam, config1_cfg())
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)


def test_brute_spheres_only_scene():
    """Empty box/tri tables must not upset the search."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.5, 0.5, 0.5)))
    m = b.add_material(ResponseType.REFLECTION)
    b.add_sphere((3.0, 0.0, 0.0), 1.0, m, b.add_solid_texture((1, 1, 1)))
    scene = b.build()
    org, d = _rand_rays(64, seed=3)
    _assert_matches_f64(scene, org, d)


def test_brute_mixed_classes_second_draw():
    scene = config1_scene(with_glass=True, with_tri=True)
    org, d = _rand_rays(300, seed=5)
    _assert_matches_f64(scene, org, d, max_tie_frac=0.02)


def test_brute_near_miss_field_no_phantom_hits():
    """A 600-sphere field rich in near-miss rays: a factored or
    reduced-precision sphere test flips near-miss discriminants positive
    (phantom hits); the elementwise f32 test must agree with float64."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((0.8, 0.3, 0.2))
    rng = np.random.default_rng(0)
    for _ in range(600):
        p = rng.uniform(-4, 4, 3)
        p[0] += 8
        b.add_sphere(tuple(p), 0.25, m, tex)
    scene = b.build()
    cam = make_camera((0, 0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    org, d = pixel_rays(cam)
    p = _assert_matches_f64(scene, org, d)
    assert (p < 0).mean() > 0.1          # plenty of true misses
