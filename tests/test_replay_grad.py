"""XLA path-replay gradients vs the search gradient and finite differences.

The replay (ops/trace.trace_rays with a recorded ``pid_seq``) is the
gradient step of ``optim.fit(replay_every=N)``. Its colors must equal the
search path's, its gradients on every Scene float leaf AND on (org, dir) —
the camera-pose path — must equal the search gradients, and a central
finite difference of the loss must agree with them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import RenderConfig, SceneBuilder, make_camera
from raytracer_js_tpu.config import HitBackend, ResponseType
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops.trace import record_paths, trace_rays
from raytracer_js_tpu.parallel.sharding import float_partition


def _scene(seed=0, n_sph=9):
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.45, 0.7)))
    grey = b.add_solid_texture((0.6, 0.55, 0.5))
    white = b.add_solid_texture((1.0, 0.9, 0.8))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_box((4.0, -2.5, 1.0), (1.0, 2.0, 1.5), mirror, white)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(4)]
    centers = rng.uniform([2.0, -3.0, -0.5], [8.0, 3.0, 3.0], (n_sph, 3))
    radii = rng.uniform(0.3, 0.9, n_sph)
    for i in range(n_sph):
        b.add_sphere(centers[i], float(radii[i]),
                     mirror if i % 3 == 0 else diffuse, pal[i % 4])
    b.add_sphere((5.0, 0.5, 5.0), 1.2, light, white)
    return b.build()


def _rays(w=32, h=32):
    cam = make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2, np.pi / 2)
    org, dirs = pixel_rays(cam)
    return org, dirs, jnp.arange(org.shape[0], dtype=jnp.int32)


def _losses(scene, cfg, target):
    org, dirs, rid = _rays()
    key = jax.random.key(0)
    rec = record_paths(scene, cfg, org, dirs, key, rid)
    params, rebuild = float_partition(scene)
    n = org.shape[0]

    def loss(params, org, dirs, pid_seq):
        st = trace_rays(rebuild(params), cfg, org, dirs, key, rid,
                        pid_seq=pid_seq)
        return jnp.sum((st.color - target) ** 2) / n

    return params, org, dirs, rec, loss


@pytest.mark.parametrize("refmax", [1, 2, 3])
def test_replay_forward_matches_search(refmax):
    scene = _scene()
    cfg = RenderConfig(refmax=refmax, backend=HitBackend.BRUTE, unroll=True)
    org, dirs, rid = _rays()
    key = jax.random.key(0)
    rec = record_paths(scene, cfg, org, dirs, key, rid)
    search = trace_rays(scene, cfg, org, dirs, key, rid)
    replay = trace_rays(scene, cfg, org, dirs, key, rid, pid_seq=rec)
    np.testing.assert_allclose(np.asarray(replay.color),
                               np.asarray(search.color), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(replay.status),
                                  np.asarray(search.status))


def _assert_grads_match(scene, cfg):
    rng = np.random.default_rng(3)
    target = jnp.asarray(rng.uniform(0, 1, (32 * 32, 3)).astype(np.float32))
    params, org, dirs, rec, loss = _losses(scene, cfg, target)
    l_s, g_s = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        params, org, dirs, None)
    l_r, g_r = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        params, org, dirs, rec)
    np.testing.assert_allclose(float(l_r), float(l_s), rtol=1e-6)
    for a, b in zip(g_s[0], g_r[0]):            # scene leaves
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-7)
    for i in (1, 2):                            # ray cotangents (pose path)
        np.testing.assert_allclose(np.asarray(g_r[i]), np.asarray(g_s[i]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("refmax", [2, 3])
def test_replay_grads_match_search(refmax):
    _assert_grads_match(_scene(), RenderConfig(refmax=refmax, unroll=True))


def test_replay_grads_match_search_many_spheres():
    _assert_grads_match(_scene(seed=11, n_sph=37), RenderConfig(refmax=2))


def test_replay_grad_matches_finite_difference():
    """Central difference of the replay loss along the texture color and
    the sphere radius with the largest gradients vs the autodiff gradient
    (recording held fixed)."""
    scene = _scene()
    cfg = RenderConfig(refmax=2)
    target = jnp.full((32 * 32, 3), 0.3, jnp.float32)
    params, org, dirs, rec, loss = _losses(scene, cfg, target)
    grads = jax.grad(loss)(params, org, dirs, rec)
    f = jax.jit(lambda p: loss(p, org, dirs, rec))
    leaves = {id(l): i for i, l in enumerate(params)}
    rgb_i = leaves[id(scene.textures.solid_rgb)]
    rad_i = leaves[id(scene.sphere_radius)]
    for li, eps in ((rgb_i, 1e-2), (rad_i, 1e-3)):
        g = np.asarray(grads[li])
        idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)

        def shifted(delta):
            p = list(params)
            p[li] = p[li].at[idx].add(delta)
            return float(f(p))
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        ad = float(grads[li][idx])
        assert abs(ad) > 1e-6, (li, idx, ad)
        np.testing.assert_allclose(ad, fd, rtol=2e-2, atol=1e-5)


def test_sharded_fit_replay_matches_unsharded():
    """The XLA replay step composes with the mesh: the implicit psum of
    replicated-param cotangents gives the unsharded losses."""
    from raytracer_js_tpu.optim import FitConfig, fit
    from raytracer_js_tpu.parallel import make_mesh
    from raytracer_js_tpu.render import render_rays

    cfg = RenderConfig(refmax=2, backend=HitBackend.BRUTE)
    scene_true = _scene(seed=5, n_sph=4)
    cams = [make_camera((0.0, 0.0, 0.5), 32, 32, np.pi / 2, np.pi / 2)]
    key = jax.random.key(2)
    org, dirs = pixel_rays(cams[0])
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    targets = jnp.stack([render_rays(scene_true, cfg, org, dirs, key, rid)])
    start = _scene(seed=7, n_sph=4)
    fc = FitConfig(steps=3, lr=1e-2, replay_every=1)
    r_plain = fit(start, cfg, cams, targets, fc, key=key)
    r_mesh = fit(start, cfg, cams, targets, fc, key=key, mesh=make_mesh())
    np.testing.assert_allclose(r_mesh.losses, r_plain.losses,
                               rtol=1e-5, atol=1e-7)
