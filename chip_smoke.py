"""Smoke test of the raytracer on one NVIDIA GPU.

Drives the main paths once at full width, each against its plain reference,
in one process:

* FUSED frame (the Triton kernel, compiled, never interpreted) at 1920x1088,
  50 spheres, refmax 2, against BRUTE (<= 1e-4), and a rough + glass scene,
  where every pixel off by more than 1e-4 must be a proven rounding edge;
* oracle parity: the 64x64 config-1 scene through ``render_hdr`` against the
  scalar oracle (allclose 1e-4);
* big scene on OCTREE: 100k primitives at 1920x1088, refmax 2, the octree
  built by the native library (no NumPy fallback); a 64x64 centre crop
  against BRUTE, every differing pixel a proven winner tie or rounding edge;
* fit: ``optim.fit`` on 2 views of the 50-sphere scene at 1920x1088 with
  path replay; one replay gradient against the search gradient;
* precision: the HIGHEST one-hot gather equals ``jnp.take`` exactly;
* ``compiled.memory_analysis()`` of the FUSED frame and the fit step.

``--four`` runs only the 4-card phase: ``render_hdr_sharded`` over 4 GPUs
against the 1-card render (bitwise) and ``sharded_fit_step``'s loss and
gradients against the unsharded step (FOUR_RTOL).

Exits non-zero on any failure or when JAX finds no GPU. The last line of
standard output is ``{"ok": true, "device": {...}}``.

Usage: python chip_smoke.py [--four]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# the package and bench.py beside this file; tests/ for the shared test
# scenes (imported as ``scenes``: a ``tests`` package elsewhere on the path
# would shadow ``tests.scenes``)
sys.path[:0] = [_HERE, os.path.join(_HERE, "tests")]

FRAME = (1920, 1088)
OCTREE_PRIMS = 100_000
CROP = 64
TOL = 1e-4
FLIP_RTOL = 1e-5
EDGE_NUDGE = 1e-5
# FUSED pixels of the 1920x1088 rough + glass frame allowed off BRUTE, each
# still a proven edge: the H100 showed 1 in every run
MAX_EDGE_PIXELS = 8
# sharded vs unsharded fit step: f32 sums over 2M rays in another order
# moved the gradients by up to 3.8e-5 relative on the H100
FOUR_RTOL = 1e-4


def _say(*a):
    print(*a, flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _camera(w, h, pos=(0.0, 0.0, 0.5), rot_h=0.0):
    from raytracer_js_tpu import make_camera

    return make_camera(pos, w, h, np.pi / 2, np.pi / 2 * h / w, rot_h=rot_h)


def _render_fn(cam, cfg):
    import jax

    from raytracer_js_tpu import render_hdr

    return jax.jit(lambda s: render_hdr(s, cam, cfg))


def _assert_triton(compiled):
    """The kernel was compiled through Triton, not interpreted."""
    _check("__gpu$xla.gpu.triton" in compiled.as_text(),
           "FUSED frame has no Triton custom call")
    _say("fused: Triton custom call present in the compiled frame")


def _check_edges(scene, brute_cfg, cam, pixels, want):
    """Each listed pixel sits on a rounding-sensitive edge of BRUTE's own
    image (a grazing hit, a total-internal-reflection threshold, a winner
    tie): nudging its primary direction by at most EDGE_NUDGE relative
    makes BRUTE produce ``want`` (within TOL). A genuine semantic
    difference is not reachable that way."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.ops.vecmath import normalize
    from raytracer_js_tpu.render import render_rays

    if not len(pixels):
        return
    org, dirs = pixel_rays(cam)
    rng = np.random.default_rng(0)
    n_try = 256
    scales = np.geomspace(EDGE_NUDGE * 1e-2, EDGE_NUDGE, n_try)[:, None]
    render = jax.jit(lambda o, d, r: render_rays(
        scene, brute_cfg, o, d, jax.random.key(0), r))
    for k, target in zip(pixels, want):
        noise = rng.normal(size=(n_try, 3)) * scales
        d = normalize(dirs[k][None, :] + jnp.asarray(noise, jnp.float32))
        o = jnp.broadcast_to(org[k], d.shape)
        rid = jnp.full((n_try,), k, jnp.int32)      # same RNG stream
        got = np.asarray(render(o, d, rid))
        _check((np.abs(got - target) <= TOL).all(-1).any(),
               f"pixel {k}: FUSED color {target} is not reached by BRUTE "
               f"under a {EDGE_NUDGE} relative nudge")
    _say(f"fused: all {len(pixels)} differing pixels are proven edges "
         f"(BRUTE reaches the FUSED color under a <= {EDGE_NUDGE} "
         f"relative nudge of the primary ray)")


def phase_fused(scene50):
    """FUSED vs BRUTE at full width; the kernel must be the Triton call."""
    from raytracer_js_tpu import RenderConfig
    from raytracer_js_tpu.config import HitBackend

    import bench

    cam = _camera(*FRAME)
    fused_cfg = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    brute_cfg = dataclasses.replace(fused_cfg, backend=HitBackend.BRUTE)
    compiled = _render_fn(cam, fused_cfg).lower(scene50).compile()
    _assert_triton(compiled)
    _say("fused memory_analysis:", compiled.memory_analysis())
    a = np.asarray(compiled(scene50))
    b = np.asarray(_render_fn(cam, brute_cfg)(scene50))
    _check(np.isfinite(a).all(), "FUSED frame not finite")
    err = float(np.abs(a - b).max())
    _say(f"fused: {cam.w}x{cam.h} 50 spheres refmax 2 maxerr vs BRUTE "
         f"{err:.3e}")
    _check(err <= TOL, f"FUSED vs BRUTE maxerr {err} > {TOL}")

    glass = bench.build_scene(50, rough=0.4, glass=True)
    _check(glass.has_rough and glass.has_transmission, "scene class")
    cfg3 = dataclasses.replace(fused_cfg, refmax=3)
    brute3 = dataclasses.replace(cfg3, backend=HitBackend.BRUTE)
    a = np.asarray(_render_fn(cam, cfg3)(glass))
    b = np.asarray(_render_fn(cam, brute3)(glass))
    _check(np.isfinite(a).all(), "FUSED rough+glass frame not finite")
    bad = np.nonzero((np.abs(a - b) > TOL).any(-1).reshape(-1))[0]
    _say(f"fused: rough + glass refmax 3: {bad.size} of {cam.w * cam.h} "
         f"pixels differ from BRUTE by > {TOL} (maxerr "
         f"{float(np.abs(a - b).max()):.3e})")
    _check(bad.size <= MAX_EDGE_PIXELS,
           f"{bad.size} FUSED pixels differ, more than {MAX_EDGE_PIXELS}")
    _check_edges(glass, brute3, cam, bad, a.reshape(-1, 3)[bad])


def phase_oracle():
    """render_hdr on the config-1 scene against the scalar oracle."""
    from raytracer_js_tpu import render_hdr
    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.oracle import scalar
    from scenes import config1_camera, config1_cfg, config1_scene

    scene, cam = config1_scene(), config1_camera(64, 64)
    ref = scalar.render(scene, cam, config1_cfg())
    for backend in (HitBackend.BRUTE, HitBackend.FUSED):
        img = np.asarray(render_hdr(scene, cam, config1_cfg(backend=backend)))
        err = float(np.abs(img - ref).max())
        _say(f"oracle: 64x64 config 1 {backend.value} maxerr {err:.3e}")
        np.testing.assert_allclose(img, ref, rtol=TOL, atol=TOL)


def _t_of(scene, org, dirs, pid):
    """Hit parameter of each ray against its own global prim id."""
    import jax.numpy as jnp

    from raytracer_js_tpu.ops import intersect

    parts = [intersect.sphere_hit_t(org, dirs, scene.sphere_center,
                                    scene.sphere_radius),
             intersect.box_hit_t(org, dirs, scene.box_center,
                                 scene.box_half)]
    t_all = jnp.concatenate(parts, axis=1)
    t = jnp.take_along_axis(t_all, jnp.maximum(pid, 0)[:, None], 1)[:, 0]
    return np.where(np.asarray(pid) >= 0, np.asarray(t), np.inf)


def phase_octree():
    """100k primitives on OCTREE; crop parity against BRUTE."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig, render_hdr
    from raytracer_js_tpu.accel.octree import build_octree
    from raytracer_js_tpu.config import HitBackend, OctreeConfig
    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.ops.trace import record_paths, trace_rays
    from raytracer_js_tpu.render import render_rays, start_substance

    import bench
    from raytracer_js_tpu import native

    native.require()
    t0 = time.perf_counter()
    scene = bench.build_config4_scene(OCTREE_PRIMS)
    accel = build_octree(scene, OctreeConfig(max_depth=8))
    _say(f"octree: {scene.n_prims} prims, depth 8 built natively in "
         f"{time.perf_counter() - t0:.1f} s")
    w, h = FRAME
    cam = _camera(w, h)
    cfg = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    frame = jax.jit(lambda s, a: render_hdr(s, cam, cfg, accel=a))
    img = np.asarray(frame(scene, accel))
    _check(img.shape == (h, w, 3) and np.isfinite(img).all(),
           "OCTREE frame not finite")
    _say(f"octree: {w}x{h} frame finite, mean {img.mean():.4f}")

    org, dirs = pixel_rays(cam)
    ys, xs = np.meshgrid(np.arange(h // 2 - CROP // 2, h // 2 + CROP // 2),
                         np.arange(w // 2 - CROP // 2, w // 2 + CROP // 2),
                         indexing="ij")
    idx = jnp.asarray((ys * w + xs).reshape(-1))
    org, dirs = org[idx], dirs[idx]
    rid = idx.astype(jnp.int32)
    key = jax.random.key(0)
    brute = dataclasses.replace(cfg, backend=HitBackend.BRUTE)
    refr0 = jnp.broadcast_to(start_substance(scene, cam.pos), (idx.shape[0],))

    @jax.jit
    def crop(scene, accel):
        out = []
        for c in (cfg, brute):
            out.append(render_rays(scene, c, org, dirs, key, rid,
                                   accel=accel))
            out.append(record_paths(scene, c, org, dirs, key, rid,
                                    start_refr=refr0, accel=accel))
        return out

    col_o, rec_o, col_b, rec_b = (np.asarray(v) for v in crop(scene, accel))
    bad = np.abs(col_o - col_b).max(axis=1) > TOL
    flips = (rec_o != rec_b).any(axis=1)
    _check(not (bad & ~flips).any(),
           "OCTREE/BRUTE colors differ where the recorded winners agree")
    ties, edges = 0, []
    for i in np.nonzero(bad)[0]:
        b = int(np.argmax(rec_o[i] != rec_b[i]))   # first differing bounce
        o, d = org[i:i + 1], dirs[i:i + 1]
        if b:
            st = trace_rays(scene, dataclasses.replace(brute, refmax=b), o, d,
                            key, rid[i:i + 1], start_refr=refr0[i:i + 1],
                            pid_seq=jnp.asarray(rec_b[i:i + 1, :b]))
            o, d = st.org, st.dir
        ta = _t_of(scene, o, d, jnp.asarray(rec_o[i:i + 1, b]))[0]
        tb = _t_of(scene, o, d, jnp.asarray(rec_b[i:i + 1, b]))[0]
        if abs(ta - tb) <= FLIP_RTOL * max(abs(ta), abs(tb)):
            ties += 1
        else:                    # hit vs miss: must be a grazing edge
            edges.append(i)
    _check_edges(scene, brute, cam, np.asarray(idx)[edges], col_o[edges])
    _say(f"octree: {CROP}x{CROP} crop vs BRUTE maxerr "
         f"{float(np.abs(col_o - col_b).max()):.3e}, {int(bad.sum())} "
         f"pixels > {TOL}: {ties} winner ties within {FLIP_RTOL} relative, "
         f"{len(edges)} proven edges ({int(flips.sum())} rays with "
         f"differing winners)")


def _worst_relative(got, ref):
    """Largest leaf-wise max |got - ref| over max |ref| (empty leaves and
    all-zero reference leaves compare absolutely)."""
    worst = 0.0
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        if r.size:
            scale = max(float(np.abs(r).max()), 1e-30)
            worst = max(worst, float(np.abs(g - r).max()) / scale)
    return worst


def phase_fit(scene50):
    """optim.fit with path replay; replay gradient vs search gradient."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig
    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.ops.trace import record_paths, trace_rays
    from raytracer_js_tpu.optim import FitConfig, fit
    from raytracer_js_tpu.parallel.sharding import float_partition
    from raytracer_js_tpu.render import render_rays, start_substance

    cfg = RenderConfig(refmax=2)
    cams = [_camera(*FRAME), _camera(*FRAME, pos=(0.0, 1.0, 0.8), rot_h=0.2)]
    key = jax.random.key(0)
    # colors and geometry both off target, so every float leaf of the
    # spheres and textures carries a real gradient
    start = scene50.replace(
        textures=scene50.textures.replace(
            solid_rgb=scene50.textures.solid_rgb * 0.8),
        sphere_radius=scene50.sphere_radius * 1.05,
        sphere_center=scene50.sphere_center + 0.02)

    def view_rays(cam, v):
        org, dirs = pixel_rays(cam)
        rid = jnp.arange(org.shape[0], dtype=jnp.int32) + v * org.shape[0]
        return org, dirs, rid

    targets = jnp.stack([
        jax.jit(lambda s, o, d, r: render_rays(s, cfg, o, d, key, r))(
            scene50, *view_rays(c, v)) for v, c in enumerate(cams)])
    res = fit(start, cfg, cams, targets,
              FitConfig(steps=3, lr=1e-2, replay_every=2), key=key)
    _say(f"fit: 2 views {cams[0].w}x{cams[0].h} replay_every=2 losses",
         res.losses)
    _check(len(res.losses) == 3 and np.isfinite(res.losses).all(),
           "fit losses not finite")

    params, rebuild = float_partition(start)
    org, dirs, rid = view_rays(cams[0], 0)
    refr0 = jnp.broadcast_to(start_substance(start, cams[0].pos),
                             (org.shape[0],))
    rays = (org, dirs, rid, refr0, targets[0])   # arguments, not constants

    def loss(params, rec, org, dirs, rid, refr0, target):
        st = trace_rays(rebuild(params), cfg, org, dirs, key, rid,
                        start_refr=refr0, pid_seq=rec)
        return jnp.mean((st.color - target) ** 2)

    rec = jax.jit(lambda p, o, d, r, rf: record_paths(
        rebuild(p), cfg, o, d, key, r, start_refr=rf))(params, *rays[:4])
    grad = jax.jit(jax.grad(loss))
    step = grad.lower(params, rec, *rays).compile()
    _say("fit step memory_analysis:", step.memory_analysis())
    g_replay = step(params, rec, *rays)
    g_search = grad(params, None, *rays)
    worst = _worst_relative(g_replay, g_search)
    _say(f"fit: replay vs search gradient, worst relative error {worst:.3e}")
    _check(worst <= TOL, f"replay gradient off by {worst} relative")


def phase_precision():
    """A HIGHEST one-hot gather selects rows exactly (no TF32 rounding)."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu.ops.gather import onehot_gather

    k1, k2 = jax.random.split(jax.random.key(1))
    table = jax.random.normal(k1, (1000, 16), jnp.float32)
    idx = jax.random.randint(k2, (1 << 20,), 0, 1000, jnp.int32)
    got = np.asarray(jax.jit(onehot_gather)(idx, table))
    _check(np.array_equal(got, np.asarray(jnp.take(table, idx, axis=0))),
           "one-hot gather differs from jnp.take")
    _say("precision: one-hot gather == jnp.take bitwise (1M x 1000 x 16)")


def phase_four(scene50):
    """4-card mesh: sharded render bitwise, sharded fit step gradients."""
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig, render_hdr
    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.parallel import make_mesh
    from raytracer_js_tpu.parallel.sharding import (float_partition,
                                                    render_hdr_sharded,
                                                    sharded_fit_step)
    from raytracer_js_tpu.render import render_rays

    _check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, not 4")
    mesh = make_mesh()
    cam = _camera(*FRAME)
    cfg = RenderConfig(refmax=2)
    key = jax.random.key(0)
    one = np.asarray(jax.jit(lambda s: render_hdr(s, cam, cfg, key=key))(
        scene50))
    sharded = np.asarray(render_hdr_sharded(mesh, scene50, cam, cfg, key))
    _check(np.array_equal(one, sharded),
           f"sharded render differs by {np.abs(one - sharded).max()}")
    _say("four: render_hdr_sharded over 4 cards bitwise equal to 1 card")

    target = jnp.asarray(0.5 * one.reshape(-1, 3))
    loss_s, grads_s = sharded_fit_step(mesh, scene50, cfg, cam, target, key)
    params, rebuild = float_partition(scene50)
    org, dirs = pixel_rays(cam)
    n = org.shape[0]
    rid = jnp.arange(n, dtype=jnp.int32)

    def loss(p, org, dirs, rid, target):
        c = render_rays(rebuild(p), cfg, org, dirs, key, rid)
        return jnp.sum((c - target) ** 2) / n

    loss_1, grads_1 = jax.jit(jax.value_and_grad(loss))(params, org, dirs,
                                                        rid, target)
    loss_err = abs(float(loss_s) - float(loss_1)) / abs(float(loss_1))
    worst = _worst_relative(grads_s, grads_1)
    _say(f"four: sharded_fit_step vs unsharded step, loss relative error "
         f"{loss_err:.3e}, gradient worst relative error {worst:.3e} "
         f"(limit {FOUR_RTOL})")
    _check(loss_err <= FOUR_RTOL, f"sharded loss off by {loss_err} relative")
    _check(worst <= FOUR_RTOL, f"sharded gradients off by {worst} relative")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card phase")
    args = ap.parse_args()

    import jax

    from raytracer_js_tpu.utils.runtime import (enable_compile_cache,
                                                gpu_name_and_power)

    dev = jax.devices()[0]
    _say(f"jax {jax.__version__}, device {dev.device_kind}, "
         f"{len(jax.devices())} device(s)")
    _say(f"card: {gpu_name_and_power()}")
    if dev.platform != "gpu":
        _say(f"FAIL: JAX found no GPU (platform {dev.platform!r})")
        return 1
    enable_compile_cache()

    import bench

    scene50 = bench.build_scene(50)
    phases = ([("four", lambda: phase_four(scene50))] if args.four else [
        ("fused", lambda: phase_fused(scene50)),
        ("oracle", phase_oracle),
        ("octree", phase_octree),
        ("fit", lambda: phase_fit(scene50)),
        ("precision", phase_precision),
    ])
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        _say(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
