"""Fused whole-trace kernel (Pallas, Triton route) vs the XLA wavefront loop.

On the CPU the kernel runs in the Pallas interpreter; the same program
compiles through Triton on a GPU (chip_smoke.py checks it there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_js_tpu import RenderConfig, ResponseType, SceneBuilder, make_camera
from raytracer_js_tpu.kernels.trace_fused import supports, trace_rays_fused
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops.trace import trace_rays

from scenes import config1_cfg, config1_scene


def _compare(scene, cam, cfg):
    org, dirs = pixel_rays(cam)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    key = jax.random.key(0)
    ref = trace_rays(scene, cfg, org, dirs, key, rid)
    color, status = trace_rays_fused(scene, cfg, org, dirs)
    np.testing.assert_allclose(np.asarray(color), np.asarray(ref.color),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(status), np.asarray(ref.status))


def test_supports_gate():
    assert supports(config1_scene())
    # transmission and roughness are in-class (in-kernel containment scan
    # / counter-RNG scatter); image textures are excluded
    assert supports(config1_scene(with_glass=True))
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0, 0, 0)))
    rough = b.add_material(ResponseType.REFLECTION, mirror=True,
                           roughness=0.5)
    b.add_sphere((1, 0, 0), 0.5, rough, b.add_solid_texture((1, 1, 1)))
    assert supports(b.build())
    b2 = SceneBuilder()
    img = np.full((4, 4, 3), 0.5, np.float32)
    b2.set_sky(b2.add_image_texture(img))
    assert not supports(b2.build())


def _ext_scene(trans=False, rough=0.0, seed=5):
    """Mixed extended-class scene: ground box, mirror, glass (defined and
    undefined substance), emissive."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True,
                            roughness=rough)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0, 0, -51.0), 100.0, diffuse, b.add_solid_texture((.6,) * 3))
    b.add_sphere((4, 0, 0.5), 1.0, mirror, b.add_solid_texture((.9, .2, .1)))
    if trans:
        glass_sub = b.add_substance(1.5)
        glass = b.add_material(ResponseType.TRANSMISSION)
        b.add_sphere((3, -1.5, 0.5), 0.8, glass,
                     b.add_solid_texture((.95, .95, 1.0)),
                     substance=glass_sub)
        # undefined substance: pass-through, no refraction
        # (raytracer.ts:243-248)
        b.add_sphere((3, 1.5, 0.5), 0.7, glass,
                     b.add_solid_texture((1.0, 1.0, 1.0)))
        # nested: small water sphere inside the glass one exercises the
        # innermost-containment rule
        water = b.add_substance(1.333)
        b.add_sphere((3, -1.5, 0.5), 0.35, glass,
                     b.add_solid_texture((0.9, 1.0, 1.0)), substance=water)
    b.add_sphere((5, .5, 4.0), 1.0, light, b.add_solid_texture((1.,) * 3))
    return b.build()


def test_fused_transmission_matches_wavefront():
    scene = _ext_scene(trans=True)
    assert supports(scene)
    cam = make_camera((0.0, 0.0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    _compare(scene, cam, RenderConfig(refmax=3))


def test_fused_rough_matches_wavefront():
    """Identical counter-RNG streams: the fused kernel's in-kernel scatter
    reproduces the XLA path's draws (same (key, rid, bounce) hash)."""
    scene = _ext_scene(rough=0.5)
    cam = make_camera((0.0, 0.0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    _compare(scene, cam, RenderConfig(refmax=2))


def test_fused_rough_transmission_combined():
    scene = _ext_scene(trans=True, rough=0.4)
    cam = make_camera((0.0, 0.0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    _compare(scene, cam, RenderConfig(refmax=3))


def test_fused_frame_rough_spp_matches_brute():
    """Frame kernel + spp accumulation on a rough scene vs the XLA path
    (render_hdr end-to-end, same RNG stream ids pixel*spp + s)."""
    import dataclasses

    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.render import render_hdr

    scene = _ext_scene(rough=0.6)
    cam = make_camera((0.0, 0.0, 0.5), 24, 16, np.pi / 2, np.pi / 3)
    key = jax.random.key(11)
    cfg = RenderConfig(refmax=2, spp=2, backend=HitBackend.FUSED)
    a = np.asarray(render_hdr(scene, cam, cfg, key=key))
    b = np.asarray(render_hdr(
        scene, cam, dataclasses.replace(cfg, backend=HitBackend.BRUTE),
        key=key))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_fused_matches_wavefront_config1():
    scene = config1_scene()
    assert supports(scene)
    cam = make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    _compare(scene, cam, config1_cfg())


def test_fused_matches_wavefront_mirror_exhaust():
    """Parallel mirrors: exhaustion + emissive ISL paths."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_box((-3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_sphere((0.0, 0.0, -5.5), 1.0, light, white)
    scene = b.build()
    cam = make_camera((0.0, 0.0, 0.0), 16, 16, np.pi / 2, np.pi / 2)
    _compare(scene, cam, RenderConfig(refmax=4))


def test_fused_with_triangles():
    scene = config1_scene(with_tri=True)
    assert supports(scene)
    cam = make_camera((0.0, 0.0, 0.5), 12, 12, np.pi / 2, np.pi / 2)
    _compare(scene, cam, config1_cfg())


def test_fused_empty_scene_pure_sky():
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.6, 0.9)))
    scene = b.build()
    cam = make_camera((0.0, 0.0, 0.0), 8, 8, np.pi / 2, np.pi / 2)
    _compare(scene, cam, RenderConfig(refmax=2))


def test_render_fused_backend_end_to_end():
    from raytracer_js_tpu import render_hdr
    from raytracer_js_tpu.config import HitBackend

    scene = config1_scene()
    cam = make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    img_b = np.asarray(render_hdr(scene, cam, config1_cfg()))
    # FUSED render_hdr routes to the frame kernel (in-kernel raygen):
    # equal to ULP noise, not bitwise
    img_f = np.asarray(render_hdr(scene, cam,
                                  config1_cfg(backend=HitBackend.FUSED)))
    np.testing.assert_allclose(img_f, img_b, rtol=1e-4, atol=1e-5)
    # transmission is in-class: the glass scene runs the fused kernel
    # (ULP-level agreement)
    glass = config1_scene(with_glass=True)
    img_g = np.asarray(render_hdr(glass, cam,
                                  config1_cfg(backend=HitBackend.FUSED)))
    img_gb = np.asarray(render_hdr(glass, cam, config1_cfg()))
    np.testing.assert_allclose(img_g, img_gb, rtol=1e-4, atol=1e-5)
    # an image-textured scene DOES fall back (out of fused class)
    bi = SceneBuilder()
    bi.set_sky(bi.add_image_texture(np.full((4, 4, 3), 0.4, np.float32)))
    d = bi.add_material(ResponseType.REFLECTION)
    bi.add_sphere((4, 0, 0.5), 1.0, d, bi.add_solid_texture((.9, .2, .1)))
    imgsc = bi.build()
    img_i = np.asarray(render_hdr(imgsc, cam,
                                  config1_cfg(backend=HitBackend.FUSED)))
    img_ib = np.asarray(render_hdr(imgsc, cam, config1_cfg()))
    np.testing.assert_array_equal(img_i, img_ib)


def test_frame_fused_nonsquare_offgrid():
    """Frame kernel (in-kernel raygen) on a non-square image whose pixel
    count is not a multiple of the ray block: the in-kernel (x, y) <- index
    decode must match pixel_rays exactly."""
    from raytracer_js_tpu import render_hdr
    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.kernels import trace_fused as tf

    scene = config1_scene()
    assert tf.supports(scene)
    cam = make_camera((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3,
                      rot_h=0.3, rot_v=-0.2)
    img_b = np.asarray(render_hdr(scene, cam, config1_cfg()))
    img_f = np.asarray(render_hdr(scene, cam,
                                  config1_cfg(backend=HitBackend.FUSED)))
    assert img_f.shape == (24, 40, 3)
    np.testing.assert_allclose(img_f, img_b, rtol=1e-4, atol=1e-5)


def test_frame_fused_mirror_bounces():
    """Mirror continuation through the frame kernel over 4 bounces
    (exhaustion and the emissive inverse-square law)."""
    from raytracer_js_tpu import RenderConfig, render_hdr
    from raytracer_js_tpu.config import HitBackend

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_box((-3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_sphere((0.0, 0.0, -5.5), 1.0, light, white)
    scene = b.build()
    cam = make_camera((0.0, 0.0, 0.0), 16, 16, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=4)
    img_b = np.asarray(render_hdr(scene, cam, cfg))
    img_f = np.asarray(render_hdr(
        scene, cam, RenderConfig(refmax=4, backend=HitBackend.FUSED)))
    np.testing.assert_allclose(img_f, img_b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 37, 129, 3 * 128 - 5])
def test_wavefront_padding_non_multiple(n):
    """Ray counts off the block are edge-padded and sliced back: outputs
    have exactly n rows and match the XLA loop."""
    import raytracer_js_tpu.kernels.trace_fused as tf

    assert n % tf.BLOCK
    scene = config1_scene()
    cam = make_camera((0.0, 0.0, 0.5), 24, 16, np.pi / 2, np.pi / 2)
    org, dirs = pixel_rays(cam)
    org, dirs = org[:n], dirs[:n]
    rid = jnp.arange(n, dtype=jnp.int32)
    cfg = config1_cfg()
    ref = trace_rays(scene, cfg, org, dirs, jax.random.key(0), rid)
    color, status = trace_rays_fused(scene, cfg, org, dirs)
    assert color.shape == (n, 3) and status.shape == (n,)
    np.testing.assert_allclose(np.asarray(color), np.asarray(ref.color),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(status), np.asarray(ref.status))


@pytest.mark.parametrize("w,h", [(13, 7), (129, 3)])
def test_frame_padding_non_multiple(w, h):
    """Frames whose pixel count is off the block: padded lanes repeat the
    last pixel and are dropped; the image matches BRUTE."""
    from raytracer_js_tpu import render_hdr
    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.kernels import trace_fused as tf

    assert (w * h) % tf.BLOCK
    scene = config1_scene()
    cam = make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2, np.pi / 3)
    img_f = np.asarray(render_hdr(scene, cam,
                                  config1_cfg(backend=HitBackend.FUSED)))
    img_b = np.asarray(render_hdr(scene, cam, config1_cfg()))
    assert img_f.shape == (h, w, 3)
    np.testing.assert_allclose(img_f, img_b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend,interpret", [("cpu", True), ("gpu", False)])
def test_interpreter_only_on_cpu(monkeypatch, backend, interpret):
    import raytracer_js_tpu.kernels.trace_fused as tf

    monkeypatch.setattr(tf.jax, "default_backend", lambda: backend)
    assert tf.use_interpreter() is interpret


def test_other_backends_raise(monkeypatch):
    """No silent fallback: a backend with no kernel route raises."""
    import raytracer_js_tpu.kernels.trace_fused as tf

    monkeypatch.setattr(tf.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no kernel route"):
        tf.use_interpreter()
    scene = config1_scene()
    org = jnp.zeros((4, 3), jnp.float32)
    dirs = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (4, 1))
    with pytest.raises(RuntimeError):
        trace_rays_fused(scene, RenderConfig(refmax=1), org, dirs)


def test_compiled_route_lowers_to_triton():
    """With interpretation off the kernel lowers for CUDA as a Triton
    custom call (lowering only; compiling needs the card)."""
    import raytracer_js_tpu.kernels.trace_fused as tf
    from raytracer_js_tpu.models.camera import angle_tables

    scene = config1_scene(with_glass=True, with_tri=True)
    cam = make_camera((0.0, 0.0, 0.5), 16, 8, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=2)
    fpar, ipar = tf._params(scene, None, None, cam=cam)
    lowered = tf._frame_call.trace(
        angle_tables(cam), fpar, ipar, *tf._pack_prims(scene),
        meta=tf._meta(scene, cfg, False), w=cam.w, n_pix=cam.w * cam.h,
        interpret=False).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text and "div.rn.f32" in text
