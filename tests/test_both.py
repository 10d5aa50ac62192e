"""Genuine ResponseType.BOTH (Fresnel-split EXTENSION).

The reference declares BOTH but its trace loop default-returns on it
(material.ts:25, raytracer.ts:250-251). ``RenderConfig.fresnel_both=False``
(default) reproduces that terminal behavior; True continues each BOTH hit
as the reflected OR refracted ray with Schlick probability drawn from the
(seed, ray id, bounce) counter RNG — identical streams in every backend
and in the scalar oracle, so the golden contract stays allclose(1e-4).
"""
import jax
import numpy as np
import pytest

import raytracer_js_tpu as rt
from raytracer_js_tpu import RenderConfig, ResponseType, SceneBuilder
from raytracer_js_tpu.config import HitBackend
from raytracer_js_tpu.oracle import scalar
from raytracer_js_tpu.ops import sampling


def both_scene():
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    red = b.add_solid_texture((0.9, 0.2, 0.1))
    diffuse = b.add_material(ResponseType.REFLECTION)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    both = b.add_material(ResponseType.BOTH)
    glass = b.add_substance(1.5)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    # BOTH glass ball in front of the camera; red wall + light behind it so
    # reflected and refracted continuations see different radiance
    b.add_sphere((2.4, 0.0, 0.5), 0.9, both, white, glass)
    b.add_sphere((6.0, 0.0, 0.5), 1.2, diffuse, red)
    b.add_sphere((4.0, 0.0, 4.5), 1.1, light, white)
    return b.build()


def test_scene_flags():
    scene = both_scene()
    assert scene.has_both
    assert scene.has_transmission  # BOTH rides the transmission machinery


@pytest.mark.parametrize("fresnel", [False, True])
def test_both_golden_vs_oracle(fresnel):
    scene = both_scene()
    cam = rt.make_camera((0.0, 0.0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=4, backend=HitBackend.BRUTE,
                       fresnel_both=fresnel)
    key = jax.random.key(7)
    hdr = np.asarray(rt.render_hdr(scene, cam, cfg, key=key))
    seed = int(np.asarray(sampling.seed_from_key(key)))
    ref = scalar.render(scene, cam, cfg, seed=seed)
    np.testing.assert_allclose(hdr, ref, atol=1e-4)


def test_both_default_matches_reference_terminal():
    """fresnel_both=False must keep the reference's default-return: the
    BOTH hit terminates with its modulated color (same as a non-mirror
    REFLECTION hit of the same geometry)."""
    scene = both_scene()
    cam = rt.make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=4, backend=HitBackend.BRUTE)
    hdr = np.asarray(rt.render_hdr(scene, cam, cfg))
    # center pixels look straight at the white BOTH ball -> kept white-ish
    c = hdr[8, 8]
    assert np.all(np.isfinite(hdr))
    np.testing.assert_allclose(c, [1.0, 1.0, 1.0], atol=1e-5)


def test_both_split_changes_image_and_is_deterministic():
    scene = both_scene()
    cam = rt.make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    key = jax.random.key(3)
    off = np.asarray(rt.render_hdr(
        scene, cam, RenderConfig(refmax=4, backend=HitBackend.BRUTE),
        key=key))
    on1 = np.asarray(rt.render_hdr(
        scene, cam, RenderConfig(refmax=4, backend=HitBackend.BRUTE,
                                 fresnel_both=True), key=key))
    on2 = np.asarray(rt.render_hdr(
        scene, cam, RenderConfig(refmax=4, backend=HitBackend.BRUTE,
                                 fresnel_both=True), key=key))
    assert np.array_equal(on1, on2)          # counter RNG: deterministic
    assert np.abs(on1 - off).max() > 1e-3    # the split actually engages


def test_both_backends_agree():
    """FUSED routes BOTH scenes to the XLA wavefront path (supports() is
    False), so every backend renders BRUTE's image."""
    from raytracer_js_tpu.kernels import trace_fused

    scene = both_scene()
    assert not trace_fused.supports(scene)
    cam = rt.make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    key = jax.random.key(11)
    out = {}
    for bk in (HitBackend.BRUTE, HitBackend.FUSED):
        cfg = RenderConfig(refmax=4, backend=bk, fresnel_both=True)
        out[bk] = np.asarray(rt.render_hdr(scene, cam, cfg, key=key))
    np.testing.assert_array_equal(out[HitBackend.FUSED],
                                  out[HitBackend.BRUTE])
