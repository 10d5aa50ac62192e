"""Live interactive session — the PlayerInterface analogue.

The reference runs a pointer-lock/WASD browser loop at a 16.6 ms tick:
key/mouse events move or rotate the camera, every motion resets the
exposure accumulation, and idle frames keep averaging into the buffer
(/root/reference/src/main.ts:154-339, tick at :254-263, keys at
:293-329, 16.6 ms interval at :210). This module is the terminal-native
re-design: an ANSI-truecolor half-block "canvas" (two pixels per
character cell), raw-tty keyboard input, and the same
motion -> reset-exposure -> re-accumulate semantics driven by a
render-bound loop instead of a wall-clock interval.

Key map (event_keydown, main.ts:293-329, pointer-lock mouse -> arrows):

=========  ==============================================
key        effect
=========  ==============================================
w/a/s/d    planar move forward/left/back/right (:301-313)
space      move up (:297-299)
c          move down ('Shift' :315-317 — Shift has no
           terminal keycode of its own)
arrows     rotate (the mousemove analogue, :279-283)
r          reset camera angles (:314)
t          cycle tone mapper (:318-320)
q / Ctrl-C quit (the browser tab close)
=========  ==============================================

The control logic is pure (``LiveState`` + :func:`apply_key` +
:func:`tick`) so tests drive it without a tty; ``main`` owns the raw
terminal. Works on any backend; keep the frame small (the default
128x128 matches the reference demo canvas, dist/test.html:9).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RenderConfig, ToneMapConfig, ToneMapperKind
from .models import camera as cam_mod
from .models.camera import Camera
from .models.scene import Scene
from .render import render_hdr
from .utils.profiling import SMA
from .view import exposure as ex
from .view.tonemap import tonemap

#: reference PlayerInterfaceConfig defaults (main.ts:165-179 via :345-352)
MOVE_STEP = 0.1
#: rotation per arrow press — the mouse-step angle x a comfortable count
ROT_STEP = 0.05

_MAPPERS = (ToneMapperKind.STDDEV_AROUND_MEAN,
            ToneMapperKind.ABSDEV_AROUND_MEAN,
            ToneMapperKind.DR_LIMITED,
            ToneMapperKind.IDENTITY)


@dataclasses.dataclass
class LiveState:
    camera: Camera
    buf: ex.ExposureBuffer
    mapper: int = 0
    moved: bool = False
    quit: bool = False


def reset_angles(cam: Camera) -> Camera:
    """camera.reset_angles (camera.ts:84-88): identity triad, keep pos."""
    return cam_mod.make_camera(np.asarray(cam.pos), cam.w, cam.h,
                               cam.fov_h, cam.fov_v)


def apply_key(st: LiveState, key: str) -> LiveState:
    """Pure key handler mirroring event_keydown/event_mousemove."""
    cam = st.camera
    moved = True
    if key == "w":
        cam = cam_mod.move_xy_forward(cam, MOVE_STEP)
    elif key == "s":
        cam = cam_mod.move_xy_forward(cam, -MOVE_STEP)
    elif key == "a":
        lf = cam.left[:2]
        lf = lf / (jnp.linalg.norm(lf) + 1e-20)
        cam = cam_mod.move(cam, jnp.concatenate(
            [lf * MOVE_STEP, jnp.zeros((1,), cam.pos.dtype)]))
    elif key == "d":
        lf = cam.left[:2]
        lf = lf / (jnp.linalg.norm(lf) + 1e-20)
        cam = cam_mod.move(cam, jnp.concatenate(
            [-lf * MOVE_STEP, jnp.zeros((1,), cam.pos.dtype)]))
    elif key == " ":
        cam = cam_mod.move(cam, (0.0, 0.0, MOVE_STEP))
    elif key == "c":
        cam = cam_mod.move(cam, (0.0, 0.0, -MOVE_STEP))
    elif key == "LEFT":
        cam = cam_mod.rotate_h(cam, ROT_STEP)
    elif key == "RIGHT":
        cam = cam_mod.rotate_h(cam, -ROT_STEP)
    elif key == "UP":
        cam = cam_mod.rotate_v(cam, ROT_STEP, lock=True)
    elif key == "DOWN":
        cam = cam_mod.rotate_v(cam, -ROT_STEP, lock=True)
    elif key == "r":
        cam = reset_angles(cam)
    elif key == "t":
        return dataclasses.replace(
            st, mapper=(st.mapper + 1) % len(_MAPPERS), moved=False)
    elif key in ("q", "\x03"):
        return dataclasses.replace(st, quit=True, moved=False)
    else:
        moved = False
    # any motion restarts the progressive accumulation
    # (event_keydown/mousemove -> ebuffer.reset_exposure, main.ts:285/325)
    buf = ex.reset(st.buf) if moved else st.buf
    return dataclasses.replace(st, camera=cam, buf=buf, moved=moved)


def tick(st: LiveState, scene: Scene, cfg: RenderConfig, frame_fn,
         key: jax.Array) -> LiveState:
    """One exposure frame: render + accumulate (tick_fn, main.ts:410-414).

    ``frame_fn(scene, camera_pose, rng_key) -> [h, w, 3]`` is the jitted
    renderer; the RNG key varies per frame so rough scenes keep converging
    (exposure_buffer.ts:53-60's next_frame gate is the buf max_frames).
    """
    frame = frame_fn(scene, st.camera, key)
    return dataclasses.replace(st, buf=ex.accumulate(st.buf, frame))


def ansi_frame(img: np.ndarray) -> str:
    """[h, w, 3] floats in [0,1] -> ANSI truecolor half-block string.

    Each character cell shows two vertically stacked pixels: foreground
    color = upper pixel with '▀' (UPPER HALF BLOCK), background =
    lower pixel — the terminal analogue of CanvasScreen's putImageData.
    """
    u8 = np.clip(np.rint(np.asarray(img) * 255.0), 0, 255).astype(np.int32)
    h, w, _ = u8.shape
    if h % 2:
        u8 = np.concatenate([u8, np.zeros((1, w, 3), np.int32)])
        h += 1
    rows = []
    for y in range(0, h, 2):
        cells = []
        for x in range(w):
            t = u8[y, x]
            b = u8[y + 1, x]
            cells.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                         f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def read_keys(timeout_s: float = 0.0):
    """Drain pending raw-tty key presses -> list of key names."""
    import select

    keys = []
    while select.select([sys.stdin], [], [], timeout_s)[0]:
        ch = sys.stdin.read(1)
        if ch == "\x1b":                       # arrow escape sequences
            rest = sys.stdin.read(2) if select.select(
                [sys.stdin], [], [], 0.01)[0] else ""
            keys.append({"[A": "UP", "[B": "DOWN", "[C": "RIGHT",
                         "[D": "LEFT"}.get(rest, "ESC"))
        else:
            keys.append(ch)
        timeout_s = 0.0
    return keys


def run(scene: Scene, camera: Camera, cfg: Optional[RenderConfig] = None,
        max_frames: int = 256, rng_seed: int = 0,
        out=sys.stdout) -> None:
    """Interactive loop on the controlling terminal (raw mode)."""
    import termios
    import tty

    cfg = cfg or RenderConfig(refmax=4)     # REFMAX main.ts:48
    frame_fn = jax.jit(lambda s, c, k: render_hdr(s, c, cfg, key=k))
    st = LiveState(camera=camera,
                   buf=ex.new_exposure_buffer(camera.h, camera.w,
                                              max_frames=max_frames))
    base_key = jax.random.key(rng_seed)
    fps = SMA(32)                           # FPS_PROBE_WINDOW main.ts:418
    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    out.write("\x1b[2J")                    # clear
    try:
        frame_i = 0
        while not st.quit:
            for k in read_keys():
                st = apply_key(st, k)
            if st.quit:
                break
            t0 = time.perf_counter()
            if int(st.buf.frame_count) < max_frames:
                st = tick(st, scene, cfg,  frame_fn,
                          jax.random.fold_in(base_key, frame_i))
                frame_i += 1
            img = np.asarray(tonemap(
                st.buf, ToneMapConfig(kind=_MAPPERS[st.mapper])))
            dt = time.perf_counter() - t0
            fps.add(1.0 / max(dt, 1e-9))
            pos = np.asarray(st.camera.pos)
            y = ex.luma_mean(st.buf)
            # stats HUD (update_stats, main.ts:213-241)
            hud = (f"pos ({pos[0]:+.2f} {pos[1]:+.2f} {pos[2]:+.2f})  "
                   f"fps {fps.value:5.1f}  frames {int(st.buf.frame_count):3d}  "
                   f"luma {float(y):.3f}  mapper {_MAPPERS[st.mapper].name}  "
                   f"[wasd/space/c move, arrows look, r reset, t tone, q quit]")
            out.write("\x1b[H" + ansi_frame(img) + "\n\x1b[0K" + hud + "\n")
            out.flush()
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        out.write("\x1b[0m\n")


def main(argv=None) -> int:
    import argparse

    from .demo import build_demo_scene

    ap = argparse.ArgumentParser(description="live terminal raytracer")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--entities", type=int, default=16)
    ap.add_argument("--refmax", type=int, default=4)
    args = ap.parse_args(argv)
    scene = build_demo_scene(seed=args.seed, entities=args.entities)
    cam = cam_mod.make_camera((0.45, 0.5, 0.55), args.size, args.size,
                              np.pi / 2, np.pi / 2)
    run(scene, cam, RenderConfig(refmax=args.refmax))
    return 0


if __name__ == "__main__":
    sys.exit(main())
