"""Differentiable equiangular camera.

Re-design of the reference FPS camera (reference src/view/camera.ts).
The reference generates each pixel direction by *incrementally* rotating the
orthonormal (front, left, up) triad one fixed angle step per pixel, marching
center-out (camera.ts:207-250) — an inherently sequential construction. Here
the identical directions come from the closed form

    dir(x, y) = cos(th_h) * cos(th_v) * front
              + cos(th_h) * sin(th_v) * up
              + sin(th_h) * left

with ``th_h = (x - w//2) * fov_h / w`` and ``th_v = (y - h//2) * fov_v / h``,
which is what k Givens steps of camera.ts:318-323 compose to — without the
sequential dependency, so the whole [h, w, 3] grid is one fused expression
and is differentiable w.r.t. the pose (a gradient the reference cannot
express at all).

DOCUMENTED DIVERGENCE: the reference's scan loops index width with
``screen_h`` and height with ``screen_w`` (camera.ts:242-249), which is only
consistent for square screens (SURVEY.md §2 #28). This implementation uses
the correct bounds, identical on the square screens every reference demo and
test uses.

Note the camera basis is *orthonormal by construction* via rotate_h/rotate_v,
matching the reference's incremental Givens updates (camera.ts:121-145);
pose gradients may denormalize it, so :func:`renormalized` is provided for
optimizer loops.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import pytree

from ..ops import vecmath as vm

Array = jnp.ndarray


@pytree.dataclass
class Camera:
    """Pose pytree. ``w``/``h``/fovs are static; pose arrays are traced/diff."""

    pos: Array            # [3]
    front: Array          # [3] unit
    left: Array           # [3] unit
    up: Array             # [3] unit
    fov_h: float = pytree.field(pytree_node=False, default=float(jnp.pi / 2))
    fov_v: float = pytree.field(pytree_node=False, default=float(jnp.pi / 2))
    w: int = pytree.field(pytree_node=False, default=128)
    h: int = pytree.field(pytree_node=False, default=128)


def make_camera(pos, w: int, h: int, fov_h: float, fov_v: float,
                rot_h: float = 0.0, rot_v: float = 0.0) -> Camera:
    """Build a camera the way the reference constructs one: identity triad
    front=(1,0,0), left=(0,1,0), up=(0,0,1) (camera.ts:64-66), then optional
    horizontal/vertical rotations (camera.ts:70-74)."""
    cam = Camera(
        pos=jnp.asarray(pos, jnp.float32),
        front=jnp.array([1.0, 0.0, 0.0], jnp.float32),
        left=jnp.array([0.0, 1.0, 0.0], jnp.float32),
        up=jnp.array([0.0, 0.0, 1.0], jnp.float32),
        fov_h=float(fov_h), fov_v=float(fov_v), w=int(w), h=int(h),
    )
    if rot_h:
        cam = rotate_h(cam, rot_h)
    if rot_v:
        cam = rotate_v(cam, rot_v)
    return cam


def rotate_h(cam: Camera, angle) -> Camera:
    """Horizontal (yaw) rotation: rotate the XY projections of front/left in
    the world XY plane and rebuild up = front x left (camera.ts:121-130)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    fr_xy = cam.front[:2]
    lf_xy = cam.left[:2]
    fr_xy, _ = vm.rotate_vectors(fr_xy, vm.ortho2(fr_xy), c, s)
    lf_xy, _ = vm.rotate_vectors(lf_xy, vm.ortho2(lf_xy), c, s)
    front = jnp.concatenate([fr_xy, cam.front[2:]])
    left = jnp.concatenate([lf_xy, cam.left[2:]])
    up = vm.cross(front, left)
    return cam.replace(front=front, left=left, up=up)


def rotate_v(cam: Camera, angle, lock: bool = False) -> Camera:
    """Vertical (pitch) rotation of the (front, up) pair (camera.ts:134-145).

    ``lock=True`` reproduces the reference's vertical_locked behavior: the
    rotation is rejected (camera unchanged) when it would pitch past
    straight up/down, i.e. when the resulting up vector's Z turns negative
    (camera.ts:136-141's clamp condition).
    """
    c, s = jnp.cos(angle), jnp.sin(angle)
    front, up = vm.rotate_vectors(cam.front, cam.up, c, s)
    if lock:
        ok = up[2] >= 0.0
        front = jnp.where(ok, front, cam.front)
        up = jnp.where(ok, up, cam.up)
    return cam.replace(front=front, up=up)


def move(cam: Camera, delta) -> Camera:
    """Translate (camera.ts:162-164)."""
    return cam.replace(pos=cam.pos + jnp.asarray(delta, jnp.float32))


def move_xy_forward(cam: Camera, scale=1.0) -> Camera:
    """WASD-style planar move along the XY projection of front
    (camera.ts:167-170)."""
    fr = cam.front[:2]
    fr = fr / (jnp.linalg.norm(fr) + 1e-20)
    return move(cam, jnp.concatenate([fr * scale, jnp.zeros((1,), cam.pos.dtype)]))


def renormalized(cam: Camera) -> Camera:
    """Re-orthonormalize the triad (Gram-Schmidt) after gradient updates."""
    f = vm.normalize(cam.front)
    l = cam.left - vm.dot(cam.left, f) * f
    l = vm.normalize(l)
    u = vm.cross(f, l)
    return cam.replace(front=f, left=l, up=u)


def angle_tables(cam: Camera):
    """(cos th_h [w], sin th_h [w], cos th_v [h], sin th_v [h]) of the
    equiangular pixel grid — the per-column and per-row terms of
    :func:`pixel_rays` (also read by the fused frame kernel)."""
    x = jnp.arange(cam.w, dtype=jnp.float32)
    y = jnp.arange(cam.h, dtype=jnp.float32)
    th_h = (x - (cam.w // 2)) * (cam.fov_h / cam.w)
    th_v = (y - (cam.h // 2)) * (cam.fov_v / cam.h)
    return jnp.cos(th_h), jnp.sin(th_h), jnp.cos(th_v), jnp.sin(th_v)


def pixel_rays(cam: Camera):
    """Closed-form per-pixel unit directions -> (org [h*w, 3], dir [h*w, 3]).

    Row y, column x ordering (row-major flatten), matching the exposure
    buffer's ``(y * w + x)`` indexing (exposure_buffer.ts:62-66).
    """
    ch, sh, cv, sv = angle_tables(cam)
    ch, sh = ch[None, :], sh[None, :]                         # [1, w]
    cv, sv = cv[:, None], sv[:, None]                         # [h, 1]
    d = (
        (ch * cv)[..., None] * cam.front
        + (ch * sv)[..., None] * cam.up
        + sh[..., None] * jnp.broadcast_to(cam.left, (cam.h, cam.w, 3))
    )
    d = d.reshape(-1, 3)
    org = jnp.broadcast_to(cam.pos, d.shape)
    return org, d
