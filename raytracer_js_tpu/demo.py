"""Config-driven demo app — the batch-rendering analogue of the reference's
browser demo (/root/reference/src/main.ts).

What main.ts does interactively (random aligned scene of 16 spheres/boxes
with weighted random materials, REFMAX=4, fov pi/2, 128x128 canvas,
progressive exposure ticks, FPS HUD — main.ts:341-433), this module does as
a CLI: generate the same *kind* of scene deterministically from a seed,
render ``--frames`` progressive exposure frames, tone-map, write a PNG, and
print the throughput stats the HUD showed (SURVEY.md §2 #33: interactivity
is out of scope on an accelerator; batch rendering replaces it).

Run: ``python -m raytracer_js_tpu.demo --seed 42 --size 128 --out demo.png``
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import RenderConfig, ResponseType, SceneBuilder, make_camera
from .config import ToneMapConfig, ToneMapperKind
from .models.scene import REFR_GLASS, REFR_WATER
from .utils.profiling import RayMeter
from .view import exposure as ex
from .view.screen import write_png
from .view.view import draw

#: the reference demo's constants (main.ts:48-49)
REFMAX = 4
RANDOM_SEED = 42


def weighted_choice(rng: np.random.Generator, pairs):
    """Weighted random choice over (weight, value) pairs.

    The reference's version is broken — its comparator takes one argument
    (main.ts:84) so the sort is identity and weights skew; this is the
    correct cumulative-weight sampler (documented divergence).
    """
    weights = np.asarray([p[0] for p in pairs], np.float64)
    i = rng.choice(len(pairs), p=weights / weights.sum())
    return pairs[i][1]


def generate_aligned_entities(b: SceneBuilder, rng: np.random.Generator,
                              count: int, materials, substances, textures,
                              min_depth: int = 1, max_depth: int = 7):
    """Random scene entities with octree-aligned quantized placement — the
    generate_some_aligned_entities analogue (main.ts:97-147): each entity
    picks a depth d in [min, max], a size of 2^-d, and a position snapped to
    the 2^-d grid, so every entity exactly fills an octree cell.
    """
    for _ in range(count):
        depth = int(rng.integers(min_depth, max_depth + 1))
        size = 2.0 ** -depth
        cells = 1 << depth
        pos = (rng.integers(0, cells, 3) + 0.5) * size
        mat, sub = weighted_choice(rng, materials)
        tex = weighted_choice(rng, textures)
        if rng.random() < 0.5:
            b.add_sphere(pos, size / 2.0, mat, tex, sub)
        else:
            b.add_box(pos, size, mat, tex, sub)


def build_demo_scene(seed: int = RANDOM_SEED, entities: int = 16):
    """The demo scene: unit box world, 16 aligned random entities, sky."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    sky = b.add_solid_texture((0.30, 0.42, 0.65))
    b.set_sky(sky)

    smooth = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    diffuse = b.add_material(ResponseType.REFLECTION)
    transparent = b.add_material(ResponseType.TRANSMISSION)
    water = b.add_substance(REFR_WATER)
    glass = b.add_substance(REFR_GLASS)

    textures = [(1.0, b.add_solid_texture(rng.uniform(0.25, 1.0, 3)))
                for _ in range(8)]
    # weighted material mix akin to main.ts:116-126
    materials = [
        (4.0, (diffuse, -1)),
        (2.0, (smooth, -1)),
        (1.5, (transparent, glass)),
        (1.0, (transparent, water)),
        (1.0, (light, -1)),
    ]
    generate_aligned_entities(b, rng, entities, materials, None, textures)
    # the scene box: a unit-cube world shell the camera sits inside
    # (main.ts:393-396 adds a scene box at the root)
    b.add_box((0.5, 0.5, 0.5), 1.0, diffuse,
              b.add_solid_texture((0.55, 0.55, 0.55)))
    return b.build()


def run_orbit(args, scene, cam, cfg, tone, meter, key) -> int:
    """Camera-path ("orbit") mode — the batch analogue of the reference's
    interactive loop (main.ts:254-339): per pose, apply a move + rotate to
    the camera (camera.ts:162-188, :90-152), RESET the exposure buffer (any
    motion restarts accumulation, exposure_buffer.ts:63-66 via
    main.ts:266-330), then re-accumulate ``--frames`` progressive frames
    and write the tone-mapped pose image.
    """
    import jax

    from .models import camera as cam_mod
    from .render import render_hdr

    base, ext = (args.out.rsplit(".", 1) + ["png"])[:2]
    buf = ex.new_exposure_buffer(args.size, args.size)
    step_h = 2.0 * np.pi / args.orbit
    outs = []
    for pose in range(args.orbit):
        if pose:
            # strafe + yaw so the camera circles its view center — each
            # motion is the WASD/mouse update the PlayerInterface applies
            cam = cam_mod.move_xy_forward(cam, 0.15 * np.sin(step_h))
            cam = cam_mod.rotate_h(cam, step_h * 0.1)
            cam = cam_mod.rotate_v(cam, 0.02 * np.cos(pose), lock=True)
            buf = ex.reset(buf)         # motion -> restart accumulation
        assert int(buf.frame_count) == 0
        for f in range(args.frames):
            with meter.frame(args.size * args.size):
                frame = jax.block_until_ready(render_hdr(
                    scene, cam, cfg,
                    key=jax.random.fold_in(key, pose * args.frames + f)))
            buf = ex.accumulate(buf, frame)
        assert int(buf.frame_count) == args.frames
        outs.append(write_png(f"{base}_{pose:03d}.{ext}",
                              np.asarray(draw(buf, tone))))
    print(f"wrote {len(outs)} poses ({outs[0]} .. {outs[-1]})  "
          f"{args.size}x{args.size}  frames/pose={args.frames}  "
          f"{meter.rays_per_s / 1e6:.2f} M rays/s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=RANDOM_SEED,
                    help="scene seed (the ?seed= URL param, main.ts:149-152)")
    ap.add_argument("--size", type=int, default=128,
                    help="square frame size (dist/test.html:9)")
    ap.add_argument("--entities", type=int, default=16)
    ap.add_argument("--frames", type=int, default=4,
                    help="progressive exposure frames")
    ap.add_argument("--refmax", type=int, default=REFMAX)
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--tonemap", default="identity",
                    choices=["identity", "stddev", "absdev"])
    ap.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="camera-path mode: N poses orbiting the scene; "
                    "each motion resets the exposure buffer and each pose "
                    "re-accumulates --frames frames (the PlayerInterface "
                    "move/rotate -> reset_exposure -> tick workflow, "
                    "main.ts:254-330, as a batch path)")
    args = ap.parse_args(argv)

    import jax

    scene = build_demo_scene(args.seed, args.entities)
    cam = make_camera((0.5, 0.5, 0.5), args.size, args.size,
                      np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=args.refmax)
    tone = ToneMapConfig(kind={
        "identity": ToneMapperKind.IDENTITY,
        "stddev": ToneMapperKind.STDDEV_AROUND_MEAN,
        "absdev": ToneMapperKind.ABSDEV_AROUND_MEAN,
    }[args.tonemap])

    from .render import render_hdr

    meter = RayMeter()
    buf = ex.new_exposure_buffer(args.size, args.size)
    key = jax.random.key(args.seed)

    if args.orbit:
        return run_orbit(args, scene, cam, cfg, tone, meter, key)

    for f in range(args.frames):
        with meter.frame(args.size * args.size):
            frame = jax.block_until_ready(
                render_hdr(scene, cam, cfg, key=jax.random.fold_in(key, f)))
        buf = ex.accumulate(buf, frame)
    img = np.asarray(draw(buf, tone))
    path = write_png(args.out, img)

    m = float(ex.luma_mean(buf))
    v = float(ex.luma_variance(buf, m))
    print(f"wrote {path}  {args.size}x{args.size}  frames={int(buf.frame_count)}  "
          f"luma mean={m:.4f} sigma={v ** 0.5:.4f}  "
          f"{meter.rays_per_s / 1e6:.2f} M rays/s (fps SMA {meter.fps.value:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
