"""Statistical anchors for the stochastic scatter path (VERDICT weak #6).

The reference's Monte-Carlo machinery is the rejection-sampled unit ball
(vector_utils.ts:8-14) feeding the roughness lerp (raytracer.ts:121-133);
ops/sampling replaces it with branch-free equivalents. These tests pin the
*distributions*: uniform-in-ball (radial CDF + isotropy), hemisphere
constraint, scatter unit-norm/limits, and the 1/spp variance law of the
Monte-Carlo estimator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu.ops import sampling

N = 1 << 14


def _rng(seed=0, n=N):
    return (sampling.seed_from_key(jax.random.key(seed)),
            jnp.arange(n, dtype=jnp.int32))


def test_ball_sample_radial_cdf():
    """Uniform in ball <=> r^3 ~ Uniform(0,1): check moments and deciles."""
    v = np.asarray(sampling.ball_sample(*_rng()))
    r3 = np.sum(v * v, axis=-1) ** 1.5
    assert np.all(r3 <= 1.0 + 1e-6)
    # E[r^3] = 1/2, Var = 1/12 -> mean standard error ~ 0.0023
    assert abs(r3.mean() - 0.5) < 0.01
    hist, _ = np.histogram(r3, bins=10, range=(0.0, 1.0))
    expect = len(r3) / 10
    chi2 = np.sum((hist - expect) ** 2 / expect)
    assert chi2 < 33.0  # chi2_{9, 1e-4} ~= 33.7


def test_ball_sample_isotropy():
    """Directions are isotropic: mean ~ 0, unit-dir covariance ~ I/3."""
    v = np.asarray(sampling.ball_sample(*_rng(seed=1)))
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    assert np.all(np.abs(d.mean(axis=0)) < 0.02)
    cov = d.T @ d / len(d)
    np.testing.assert_allclose(cov, np.eye(3) / 3.0, atol=0.02)


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (0.6, -0.8, 0.0)])
def test_hemisphere_sample_constraint_and_distribution(normal):
    n = jnp.broadcast_to(jnp.asarray(normal, jnp.float32), (N, 3))
    seed, rid = _rng(seed=2)
    v = np.asarray(sampling.hemisphere_ball_sample(seed, rid, n))
    dots = v @ np.asarray(normal)
    assert np.all(dots >= -1e-7)  # hemisphere constraint (raytracer.ts:124-127)
    # folding the ball preserves the radial law and in-plane isotropy
    r3 = np.sum(v * v, axis=-1) ** 1.5
    assert abs(r3.mean() - 0.5) < 0.01
    # cos-angle-to-normal of the *folded* uniform ball is Uniform(0,1)
    cosang = dots / np.maximum(np.linalg.norm(v, axis=-1), 1e-20)
    assert abs(cosang.mean() - 0.5) < 0.01


def test_scatter_direction_limits_and_norm():
    """roughness 0 -> exactly specular; roughness 1 -> hemisphere sample
    direction; all outputs unit (raytracer.ts:129-133 normalizes)."""
    seed, rid = _rng(seed=3, n=4096)
    nrm = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (4096, 3))
    refl = jnp.broadcast_to(
        jnp.asarray([np.sqrt(0.5), 0.0, np.sqrt(0.5)], jnp.float32),
        (4096, 3))
    out0 = sampling.scatter_direction(seed, rid, 0, refl, nrm,
                                      jnp.zeros((4096,), jnp.float32))
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(refl))

    out1 = np.asarray(sampling.scatter_direction(
        seed, rid, 0, refl, nrm, jnp.ones((4096,), jnp.float32)))
    np.testing.assert_allclose(np.linalg.norm(out1, axis=-1), 1.0, atol=1e-5)
    ball = np.asarray(sampling.hemisphere_ball_sample(seed, rid, nrm))
    ball = ball / np.linalg.norm(ball, axis=-1, keepdims=True)
    np.testing.assert_allclose(out1, ball, atol=1e-5)

    # intermediate roughness: mean alignment with the specular direction
    # decreases monotonically as roughness grows
    aligns = []
    for rho in (0.2, 0.5, 0.8):
        out = np.asarray(sampling.scatter_direction(
            seed, rid, 0, refl, nrm, jnp.full((4096,), rho, jnp.float32)))
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                                   atol=1e-5)
        aligns.append(float(np.mean(out @ np.asarray(refl[0]))))
    assert aligns[0] > aligns[1] > aligns[2]


def test_spp_variance_law():
    """Monte-Carlo estimator variance scales ~ 1/spp (the array analogue of
    the reference's across-frames progressive averaging convergence,
    exposure_buffer.ts:53-91)."""
    from raytracer_js_tpu import RenderConfig, ResponseType, SceneBuilder
    from raytracer_js_tpu.models.camera import make_camera
    from raytracer_js_tpu.render import render_hdr

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.9, 0.9, 0.9)))
    rough = b.add_material(ResponseType.REFLECTION, mirror=True,
                           roughness=0.8)
    diffuse = b.add_material(ResponseType.REFLECTION)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_sphere((3.0, 0.0, 0.0), 1.2, rough,
                 b.add_solid_texture((1.0, 0.4, 0.2)))
    # contrasting surroundings so the scattered direction changes the color
    b.add_box((3.0, 0.0, -11.0), 20.0, diffuse,
              b.add_solid_texture((0.05, 0.05, 0.05)))
    b.add_sphere((3.0, 2.5, 2.5), 0.8, light,
                 b.add_solid_texture((1.0, 1.0, 1.0)))
    scene = b.build()
    cam = make_camera((0.0, 0.0, 0.0), 16, 16, np.pi / 3, np.pi / 3)

    def pixel_var(spp, n_seeds=12):
        cfg = RenderConfig(refmax=2, spp=spp)
        imgs = np.stack([
            np.asarray(render_hdr(scene, cam, cfg, key=jax.random.key(s)))
            for s in range(n_seeds)])
        return imgs.var(axis=0).mean(axis=-1)     # [h, w] across-seed var

    v1_map, v4_map = pixel_var(1), pixel_var(4)
    mask = v1_map > 1e-10                         # pixels the RNG influences
    assert mask.sum() >= 20, int(mask.sum())
    v1 = float(v1_map[mask].mean())
    v4 = float(v4_map[mask].mean())
    # 12-seed estimates: bounds loosened vs the ideal 4x accordingly
    assert v4 < v1 / 1.8, (v1, v4)     # must shrink at least ~2x
    assert v4 > v1 / 15.0, (v1, v4)
