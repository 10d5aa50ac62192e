"""Benchmark harness — prints ONE JSON line per run.

Headline metric (BASELINE.md): primary rays/s per device at 1080p, 2-bounce.
``vs_baseline`` is the ratio against the 1e9 rays/s north-star target
(the reference publishes no numbers of its own — BASELINE.md §"Published").
Every line carries the device it ran on (``device``: JAX platform, kind,
count, and the card's name and power limit from nvidia-smi).

Usage:
    python bench.py [--small] [--backend fused|brute]   # headline frame
    python bench.py --backward                          # gradient rays/s
    python bench.py --config N                          # BASELINE.md config 1..5

Config modes (BASELINE.md "Benchmark configs"):
    1: 64x64, 3 spheres + ground, 1 bounce (the CPU-oracle class), FUSED
    2: 256x256, 50 spheres, 2 bounces, FUSED
    3: 512x512, 5k-triangle mesh + spheres, image textures + image sky,
       3 bounces, OCTREE (image textures are outside the FUSED class)
    4: 1080p, 100k primitives, full reflection path, depth-8 OCTREE
    5: 8-view batch inverse-rendering step (1080p x 8 views, 1M
       primitives): OCTREE recording + XLA path-replay gradients, one
       call per view

Times are host-clock medians of ``--repeats`` calls that each end in
``jax.block_until_ready``, after one warm-up call that compiles. Without a
GPU the script exits. The octree set-up (``setup_s``) runs the native
scenekit build; the script exits if that library cannot be built.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np


def build_scene(n_spheres: int, seed: int = 42, rough: float = 0.0,
                glass: bool = False):
    """Headline scene: ground box, ``n_spheres`` random spheres (every 3rd a
    mirror of roughness ``rough``), one emissive sphere. ``glass`` makes
    every 5th non-mirror sphere glass (substance 1.5) with a water sphere
    (1.333) nested in the first, for the innermost-containment rule."""
    from raytracer_js_tpu import ResponseType, SceneBuilder

    b = SceneBuilder()
    sky = b.add_solid_texture((0.35, 0.45, 0.65))
    b.set_sky(sky)
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True,
                            roughness=rough)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    if glass:
        clear = b.add_material(ResponseType.TRANSMISSION)
        glass_sub = b.add_substance(1.5)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(seed)
    centers = rng.uniform([2.0, -6.0, -0.5], [14.0, 6.0, 5.0], (n_spheres, 3))
    radii = rng.uniform(0.15, 0.6, n_spheres)
    palette = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(8)]
    nested = None
    for i in range(n_spheres):
        if glass and i % 5 == 1:
            b.add_sphere(centers[i], float(radii[i]), clear, white, glass_sub)
            nested = nested or (centers[i], float(radii[i]) * 0.5)
        else:
            b.add_sphere(centers[i], float(radii[i]),
                         mirror if i % 3 == 0 else diffuse, palette[i % 8])
    if nested is not None:
        b.add_sphere(nested[0], nested[1], clear, white, b.add_substance(1.333))
    b.add_sphere((8.0, 0.5, 6.0), 1.0, light, white)
    return b.build()


def build_config3_scene(subdiv: int = 4, seed: int = 3):
    """512x512 class: 5k-triangle mesh + spheres, image-textured, image sky."""
    from raytracer_js_tpu import ResponseType, SceneBuilder
    from raytracer_js_tpu.utils.mesh import icosphere

    b = SceneBuilder(atlas_hw=(64, 64))
    yy = np.linspace(0.0, 1.0, 64)[:, None] * np.ones((1, 64))
    sky_img = np.stack([0.35 + 0.25 * yy, 0.45 + 0.25 * yy,
                        0.65 + 0.2 * yy], -1).astype(np.float32)
    b.set_sky(b.add_image_texture(sky_img))
    check = (np.indices((64, 64)).sum(0) % 2).astype(np.float32)[..., None]
    checker = (check * [0.55, 0.1, 0.1] + [0.25, 0.3, 0.35]).astype(np.float32)
    tex_check = b.add_image_texture(checker)
    grey = b.add_solid_texture((0.55, 0.55, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    gold = b.add_solid_texture((0.9, 0.75, 0.3))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    v, f = icosphere(subdiv, radius=1.2, center=(6.0, 0.0, 1.0))  # 5120 tris
    b.add_mesh(v, f, mirror, gold)
    b.add_sphere((4.0, -2.0, 0.6), 0.8, mirror, white)
    b.add_sphere((4.0, 2.2, 0.7), 0.9, diffuse, tex_check)
    b.add_sphere((6.0, 1.0, 5.0), 1.2, light, white)
    return b.build()


def build_config4_scene(n_prims: int = 100_000, seed: int = 7):
    """1080p class: n_prims primitives, full reflection path.

    Uniform sphere field over a slab in front of the camera, a ground box,
    and an emissive sphere; every 3rd sphere is a mirror so multi-bounce
    reflection paths stay hot.
    """
    from raytracer_js_tpu import ResponseType, SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((20.0, 0.0, -52.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(seed)
    n_s = n_prims - 2
    centers = rng.uniform([4.0, -20.0, -1.0], [44.0, 20.0, 7.0], (n_s, 3))
    radii = rng.uniform(0.05, 0.18, n_s)
    palette = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
               for _ in range(16)]
    for i in range(n_s):
        b.add_sphere(centers[i], float(radii[i]),
                     mirror if i % 3 == 0 else diffuse, palette[i % 16])
    b.add_sphere((24.0, 0.0, 14.0), 3.0, light, white)
    return b.build()


def _time(fn, arg, repeats):
    """(median seconds, all seconds) of ``repeats`` synchronous calls after
    a warm-up call (which compiles)."""
    import jax

    jax.block_until_ready(fn(arg))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _emit(metric, value, vs_baseline, detail):
    from raytracer_js_tpu.utils.runtime import device_info

    print(json.dumps({"metric": metric, "value": value, "unit": "rays/s",
                      "vs_baseline": vs_baseline, "device": device_info(),
                      "detail": detail}))


def _octree(scene, depth):
    """(octree, set-up seconds), built by the native library only."""
    from raytracer_js_tpu import native
    from raytracer_js_tpu.accel.octree import build_octree
    from raytracer_js_tpu.config import OctreeConfig

    native.require()
    t0 = time.perf_counter()
    accel = build_octree(scene, OctreeConfig(max_depth=depth))
    return accel, time.perf_counter() - t0


def _camera(w, h):
    from raytracer_js_tpu import make_camera

    return make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2, np.pi / 2 * h / w)


def run_config(args):
    """BASELINE.md benchmark configs 1-5; prints one JSON line."""
    import jax

    from raytracer_js_tpu import RenderConfig, render_hdr
    from raytracer_js_tpu.config import HitBackend

    n = args.config
    detail = {"config": n}
    accel = None
    if n == 1:
        # tests/scenes.py, imported as ``scenes``: a ``tests`` package
        # elsewhere on the path would shadow ``tests.scenes``
        sys.path.insert(0, str(pathlib.Path(__file__).parent / "tests"))
        from scenes import config1_scene

        scene, (w, h) = config1_scene(), (64, 64)
        cfg = RenderConfig(refmax=1, backend=HitBackend.FUSED)
    elif n == 2:
        scene, (w, h) = build_scene(50), (256, 256)
        cfg = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    elif n in (3, 4):
        if n == 3:
            scene, (w, h) = build_config3_scene(), (512, 512)
            cfg, depth = RenderConfig(refmax=3, backend=HitBackend.OCTREE), 6
        else:
            scene = build_config4_scene(args.c4_prims)
            (w, h), depth = (1920, 1088), 8
            cfg = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
        accel, setup_s = _octree(scene, depth)
        detail.update(n_prims=scene.n_prims, octree_depth=depth,
                      max_per_cell=accel.max_per_cell, setup_s=setup_s)
    elif n == 5:
        return run_config5(args)
    else:
        raise SystemExit(f"unknown --config {n}")

    cam = _camera(w, h)
    # the octree is an argument, not a closure: its arrays would otherwise
    # be baked into the program as constants
    fn = jax.jit(lambda s, a: render_hdr(s, cam, cfg, accel=a))
    img = fn(scene, accel)
    assert np.isfinite(np.asarray(img)).all()
    dt, times = _time(lambda s: fn(s, accel), scene, args.repeats)
    detail.update(w=w, h=h, refmax=cfg.refmax, frame_s=dt, times_s=times,
                  backend=cfg.backend.value)
    _emit(f"config{n}_rays_per_s", w * h * cfg.spp / dt, None, detail)


def run_config5(args):
    """Config 5: 1080p x 8 views, 1M primitives, inverse-rendering step.

    The production step is record + path-replay (optim/fit.replay_every):
    a forward pass records each view's discrete winners on the OCTREE
    (amortized over ``--c5-replay-every`` steps), and the per-step gradient
    differentiates the search-free XLA replay — prim-count-independent.
    Reported value = steady-state replay-backward rays/s; ``amortized``
    folds the recording in. The octree build is ``setup_s``.
    """
    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig, make_camera
    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.ops.trace import record_paths, trace_rays
    from raytracer_js_tpu.parallel.sharding import float_partition
    from raytracer_js_tpu.render import start_substance

    w, h = args.c5_res
    views = 8
    scene = build_config4_scene(args.c5_prims)
    cams = [make_camera((0.0, float(v - views // 2), 0.5), w, h,
                        np.pi / 2, np.pi / 2 * h / w) for v in range(views)]
    key = jax.random.key(0)
    params, rebuild = float_partition(scene)
    n_pix = w * h
    view_rays = [(*pixel_rays(c), jnp.arange(n_pix, dtype=jnp.int32)
                  + v * n_pix) for v, c in enumerate(cams)]

    cfg = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    accel, setup_s = _octree(scene, 8)

    @jax.jit
    def record_view(params, accel, org, dirs, rid):
        sc = rebuild(params)
        refr0 = jnp.broadcast_to(start_substance(sc, org[0]), (n_pix,))
        return record_paths(sc, cfg, org, dirs, key, rid,
                            start_refr=refr0, accel=accel)

    def record_all(params):
        return [record_view(params, accel, *r) for r in view_rays]

    t0 = time.perf_counter()
    recs = jax.block_until_ready(record_all(params))
    dt_rec_cold = time.perf_counter() - t0     # includes compilation
    t0 = time.perf_counter()
    recs = jax.block_until_ready(record_all(params))
    dt_rec = time.perf_counter() - t0          # one full 8-view recording

    # replay ignores the backend (pid_seq supplies the winners)
    cfg_replay = RenderConfig(refmax=2, backend=HitBackend.BRUTE)

    def view_loss(params, org, dirs, rid, rec):
        sc = rebuild(params)
        refr0 = jnp.broadcast_to(start_substance(sc, org[0]), (n_pix,))
        st = trace_rays(sc, cfg_replay, org, dirs, key, rid,
                        start_refr=refr0, pid_seq=rec)
        return jnp.sum(st.color ** 2) / (views * n_pix)

    vg_jit = jax.jit(jax.value_and_grad(view_loss))
    add = jax.jit(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b))

    def replay_step(params):
        loss = jnp.zeros((), jnp.float32)
        grads = None
        for r, rec in zip(view_rays, recs):
            l, g = vg_jit(params, *r, rec)
            loss = loss + l
            grads = g if grads is None else add(grads, g)
        return loss, grads

    dt, times = _time(replay_step, params, max(2, args.repeats // 2))
    rays = views * n_pix
    every = max(1, args.c5_replay_every)
    _emit("config5_backward_rays_per_s", rays / dt, None, {
        "config": 5, "views": views, "w": w, "h": h,
        "n_prims": scene.n_prims, "mode": "record+replay",
        "replay_step_s": dt, "times_s": times,
        "record_s": dt_rec, "record_cold_s": dt_rec_cold,
        "setup_s": setup_s, "replay_every": every,
        "amortized_rays_per_s": rays / (dt + dt_rec / every)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="256x256 instead of 1920x1088")
    ap.add_argument("--spheres", type=int, default=50)
    ap.add_argument("--backend", default="fused", choices=["fused", "brute"],
                    help="headline frame backend")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--backward", action="store_true",
                    help="measure backward (gradient) rays/s instead")
    ap.add_argument("--config", type=int, default=0,
                    help="run BASELINE.md config N (1..5) instead")
    ap.add_argument("--c4-prims", type=int, default=100_000)
    ap.add_argument("--c5-prims", type=int, default=1_000_000)
    ap.add_argument("--c5-res", type=int, nargs=2, default=(1920, 1088),
                    metavar=("W", "H"))
    ap.add_argument("--c5-replay-every", type=int, default=8,
                    help="recording amortization horizon for config 5")
    args = ap.parse_args()

    import jax

    from raytracer_js_tpu.utils.runtime import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py measures a GPU and found none")
    enable_compile_cache()
    if args.config:
        return run_config(args)

    from raytracer_js_tpu import RenderConfig, render_hdr
    from raytracer_js_tpu.config import HitBackend

    w, h = (256, 256) if args.small else (1920, 1088)
    scene = build_scene(args.spheres)
    cam = _camera(w, h)
    if args.backward:
        return bench_backward(scene, cam, args, w, h)

    cfg = RenderConfig(refmax=2, backend=HitBackend(args.backend))
    fn = jax.jit(lambda s: render_hdr(s, cam, cfg))
    img = fn(scene)
    assert np.isfinite(np.asarray(img)).all()
    dt, times = _time(fn, scene, args.repeats)
    rays_per_s = w * h * cfg.spp / dt
    target = 1.0e9  # BASELINE.md north-star rays/s
    _emit("primary_rays_per_s", rays_per_s, rays_per_s / target, {
        "w": w, "h": h, "refmax": cfg.refmax, "spheres": args.spheres,
        "frame_s": dt, "times_s": times, "backend": cfg.backend.value})


def bench_backward(scene, cam, args, w, h):
    """Backward (gradient) rays/s, both gradient modes (BASELINE.md
    metric 2):

    * SEARCH — value_and_grad through the BRUTE trace (the search re-runs
      in the forward of every grad step);
    * REPLAY — record the discrete winners once (ops/trace.record_paths),
      then differentiate the search-free XLA replay: the steady-state
      inverse-rendering step. The headline value is the replay grad step;
      ``record_s`` is the recording cost.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytracer_js_tpu import RenderConfig
    from raytracer_js_tpu.config import HitBackend
    from raytracer_js_tpu.models.camera import pixel_rays
    from raytracer_js_tpu.ops.trace import record_paths, trace_rays
    from raytracer_js_tpu.parallel.sharding import float_partition
    from raytracer_js_tpu.render import render_rays, start_substance

    cfg = RenderConfig(refmax=2, backend=HitBackend.BRUTE, unroll=True)
    cfg_search = cfg
    if args.spheres > 384:
        # big prim tables: remat + rolled bounds the search VJP's live set
        # to one bounce
        cfg_search = dataclasses.replace(cfg, remat=True, unroll=False)
    org, dirs = pixel_rays(cam)
    n = org.shape[0]
    rid = jnp.arange(n, dtype=jnp.int32)
    key = jax.random.key(0)
    params, rebuild = float_partition(scene)
    target = jnp.zeros((n, 3), jnp.float32)

    def loss(params):
        colors = render_rays(rebuild(params), cfg_search, org, dirs, key,
                             rid)
        return jnp.sum((colors - target) ** 2) / n

    dt_s, times_s = _time(jax.jit(jax.value_and_grad(loss)), params,
                          args.repeats)

    def record(params):
        sc = rebuild(params)
        refr0 = jnp.broadcast_to(start_substance(sc, org[0]), (n,))
        return record_paths(sc, cfg, org, dirs, key, rid, start_refr=refr0)

    rec_fn = jax.jit(record)
    dt_rec, _ = _time(rec_fn, params, args.repeats)
    pid_seq = rec_fn(params)

    def loss_replay(params, pid_seq):
        sc = rebuild(params)
        refr0 = jnp.broadcast_to(start_substance(sc, org[0]), (n,))
        st = trace_rays(sc, cfg, org, dirs, key, rid, start_refr=refr0,
                        pid_seq=pid_seq)
        return jnp.sum((st.color - target) ** 2) / n

    fn_r = jax.jit(jax.value_and_grad(loss_replay))
    dt_r, times_r = _time(lambda p: fn_r(p, pid_seq), params, args.repeats)
    _emit("backward_rays_per_s", w * h / dt_r, None, {
        "w": w, "h": h, "refmax": cfg.refmax, "spheres": args.spheres,
        "mode": "replay", "replay_s": dt_r, "replay_times_s": times_r,
        "record_s": dt_rec, "search_rays_per_s": w * h / dt_s,
        "search_s": dt_s, "search_times_s": times_s,
        "backend": cfg.backend.value})


if __name__ == "__main__":
    sys.exit(main())
