"""Gradient correctness: pixel gradients vs finite differences of the scalar
oracle (BASELINE.md: pixel-gradient allclose(1e-4) vs reference path).

The VJP boundary (SURVEY.md §7 hard part 2): gradients flow only through
continuous factors — hit point/normal recompute, color products, ISL, sky —
never through the discrete hit/miss/cell structure. Finite differences of
the *oracle* include the same discrete structure, so steps are chosen small
enough not to flip any hit decision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import RenderConfig, render_hdr
from raytracer_js_tpu.oracle import scalar as oracle

from scenes import config1_camera, config1_cfg, config1_scene


def _loss(scene, cam, cfg):
    img = render_hdr(scene, cam, cfg)
    return jnp.sum(img ** 2)


def _loss_oracle(scene, cam, cfg):
    img = oracle.render(scene, cam, cfg)
    return float(np.sum(img ** 2))


@pytest.mark.parametrize("leaf,idx", [
    ("sphere_center", (1, 0)),
    ("sphere_center", (1, 2)),
    ("sphere_radius", (1,)),
    ("sphere_radius", (3,)),   # the emissive sphere: ISL path gradient
])
def test_grad_matches_finite_difference(leaf, idx):
    scene = config1_scene()
    cam = config1_camera(12, 12)
    cfg = config1_cfg()
    from raytracer_js_tpu.parallel.sharding import float_partition

    params, rebuild = float_partition(scene)
    g_params = jax.grad(lambda p: _loss(rebuild(p), cam, cfg))(params)
    g = rebuild(g_params)
    g_val = float(np.asarray(getattr(g, leaf))[idx])

    eps = 3e-4
    arr = np.asarray(getattr(scene, leaf)).copy()
    arr_p, arr_m = arr.copy(), arr.copy()
    arr_p[idx] += eps
    arr_m[idx] -= eps
    lp = _loss_oracle(scene.replace(**{leaf: jnp.asarray(arr_p)}), cam, cfg)
    lm = _loss_oracle(scene.replace(**{leaf: jnp.asarray(arr_m)}), cam, cfg)
    fd = (lp - lm) / (2 * eps)
    assert np.isfinite(g_val)
    np.testing.assert_allclose(g_val, fd, rtol=2e-2, atol=1e-3)


def test_grad_texture_color():
    """alter_ray color-product gradient (the inverse-rendering signal for
    material colors, SURVEY.md §2 #19)."""
    scene = config1_scene()
    cam = config1_camera(12, 12)
    cfg = config1_cfg()

    def loss_tex(solid_rgb):
        sc = scene.replace(textures=scene.textures.replace(solid_rgb=solid_rgb))
        return _loss(sc, cam, cfg)

    g = np.asarray(jax.grad(loss_tex)(scene.textures.solid_rgb))
    assert np.isfinite(g).all()
    eps = 1e-3
    # red texture of sphere 0 (texture id 1), red channel
    base = np.asarray(scene.textures.solid_rgb).copy()
    for (ti, ch) in [(1, 0), (2, 1)]:
        p, m = base.copy(), base.copy()
        p[ti, ch] += eps
        m[ti, ch] -= eps
        lp = _loss_oracle(scene.replace(
            textures=scene.textures.replace(solid_rgb=jnp.asarray(p))), cam, cfg)
        lm = _loss_oracle(scene.replace(
            textures=scene.textures.replace(solid_rgb=jnp.asarray(m))), cam, cfg)
        fd = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(g[ti, ch], fd, rtol=1e-2, atol=1e-4)


def test_grad_camera_pose():
    """Camera pose gradient (a gradient the reference cannot express,
    models/camera.py) — checked against oracle finite differences."""
    scene = config1_scene()
    cam = config1_camera(12, 12)
    cfg = config1_cfg()

    def loss_pos(pos):
        return _loss(scene, cam.replace(pos=pos), cfg)

    g = np.asarray(jax.grad(loss_pos)(cam.pos))
    assert np.isfinite(g).all()
    eps = 3e-4
    for ax in range(3):
        p = np.asarray(cam.pos).copy(); p[ax] += eps
        m = np.asarray(cam.pos).copy(); m[ax] -= eps
        lp = _loss_oracle(scene, cam.replace(pos=jnp.asarray(p)), cfg)
        lm = _loss_oracle(scene, cam.replace(pos=jnp.asarray(m)), cfg)
        fd = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(g[ax], fd, rtol=2e-2, atol=1e-3)


def test_grad_finite_with_glass_and_tri():
    """Full shading graph (refraction + triangles) must stay NaN-free."""
    scene = config1_scene(with_glass=True, with_tri=True)
    cam = config1_camera(12, 12)
    cfg = config1_cfg()
    from raytracer_js_tpu.parallel.sharding import float_partition

    params, rebuild = float_partition(scene)
    g = jax.grad(lambda p: _loss(rebuild(p), cam, cfg))(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_remat_gradients_match():
    """cfg.remat recomputes bounces in the VJP instead of saving residuals
    (the big-wavefront memory knob) — gradients must be identical."""
    import dataclasses

    import jax

    from raytracer_js_tpu import RenderConfig
    from raytracer_js_tpu.models.camera import make_camera, pixel_rays
    from raytracer_js_tpu.parallel.sharding import float_partition
    from raytracer_js_tpu.render import render_rays
    from scenes import config1_scene

    scene = config1_scene()
    cam = make_camera((0, 0, 0.5), 16, 8, np.pi / 2, np.pi / 4)
    org, dirs = pixel_rays(cam)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    key = jax.random.key(0)
    params, rebuild = float_partition(scene)

    def loss(params, cfg):
        c = render_rays(rebuild(params), cfg, org, dirs, key, rid)
        return jnp.sum(c ** 2)

    cfg = RenderConfig(refmax=3)
    v0, g0 = jax.value_and_grad(loss)(params, cfg)
    v1, g1 = jax.value_and_grad(loss)(
        params, dataclasses.replace(cfg, remat=True))
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-7)
