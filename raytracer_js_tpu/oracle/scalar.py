"""Scalar NumPy reference path (the allclose oracle).

A deliberately slow, loop-per-ray re-specification of the reference engine's
behavior (/root/reference/src/raytracer.ts:166-277 and its callees), used as
the golden-image and gradient-check oracle for every array path (SURVEY.md §7
build step 1). No JAX anywhere — pure Python/NumPy scalars, so it is immune
to every vectorization/fusion bug class the array paths could have.

Behavior matches ops/trace.py bit-for-bit in float64-rounded-to-float32
(tests use allclose, not equality), including the documented divergences
from the TypeScript reference (nearest-hit, correct Snell refraction,
innermost-containing substance query) — those divergences are *defined* by
this oracle.

Stochastic scatter included: ops/sampling's counter-hash RNG is pure
integer/float arithmetic, so this oracle reproduces the EXACT same draws
(lowbias32 over (seed, ray id, bounce, salt) -> polar ball sample -> rough
lerp) in scalar Python — pass ``seed``/``rid`` (see :func:`render`) and
rough scenes golden-match every backend. Without a seed, rough materials
raise (the r1 behavior).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..config import EPS_ADVANCE, JS_EPSILON, RayStatus, ResponseType

_INF = float("inf")

# --- scalar twin of ops/sampling (counter-hash RNG) ------------------------
# constants duplicated (the oracle imports no JAX modules); a unit test
# asserts they match ops.sampling.SALT_*
_SALT_Z, _SALT_PHI, _SALT_R = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_SALT_FRESNEL = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _lowbias32(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def _hash_u32(seed: int, rid: int, bounce: int, salt: int) -> int:
    h = _lowbias32((rid & _M32) ^ (seed & _M32))
    h = _lowbias32((h + bounce * 0x68BC21EB) & _M32)
    return _lowbias32(h ^ salt)


def _uniform(seed, rid, bounce, salt) -> float:
    return float(np.float32(_hash_u32(seed, rid, bounce, salt) >> 8)
                 * np.float32(1.0 / (1 << 24)))


def _ball_sample(seed: int, rid: int, bounce: int) -> np.ndarray:
    z = 1.0 - 2.0 * _uniform(seed, rid, bounce, _SALT_Z)
    phi = 2.0 * math.pi * _uniform(seed, rid, bounce, _SALT_PHI)
    u_r = _uniform(seed, rid, bounce, _SALT_R)
    sfac = math.sqrt(max(1.0 - z * z, 0.0))
    r = math.exp(math.log(max(u_r, 2.0 ** -25)) / 3.0)
    return np.array([r * sfac * math.cos(phi), r * sfac * math.sin(phi),
                     r * z])


def _scatter_direction(seed, rid, bounce, refl, normal, rho) -> np.ndarray:
    """Scalar twin of ops/sampling.scatter_direction_xyz
    (raytracer.ts:121-133 semantics)."""
    if rho <= 0.0:
        return refl
    b = _ball_sample(seed, rid, bounce)
    if float(b @ normal) < 0.0:
        b = -b
    mixed = (1.0 - rho) * refl + rho * b
    return mixed / max(np.linalg.norm(mixed), 1e-10)


def _as_np(scene):
    """Snapshot a Scene pytree's leaves as float64 numpy for scalar math."""
    f = lambda a: np.asarray(a, np.float64)
    i = lambda a: np.asarray(a, np.int64)
    return dict(
        sc=f(scene.sphere_center), sr=f(scene.sphere_radius),
        bc=f(scene.box_center), bh=f(scene.box_half),
        t0=f(scene.tri_v0), t1=f(scene.tri_v1), t2=f(scene.tri_v2),
        mat=i(scene.prim_material), tex=i(scene.prim_texture),
        sub=i(scene.prim_substance),
        m_resp=i(scene.materials.response),
        m_light=np.asarray(scene.materials.light, bool),
        m_mirror=np.asarray(scene.materials.mirror, bool),
        m_rough=f(scene.materials.roughness),
        t_kind=i(scene.textures.kind), t_ref=i(scene.textures.ref),
        t_solid=f(scene.textures.solid_rgb), atlas=f(scene.textures.atlas),
        t_h=(None if scene.textures.img_h is None
             else i(scene.textures.img_h)),
        t_w=(None if scene.textures.img_w is None
             else i(scene.textures.img_w)),
        sub_refr=f(scene.sub_refr), default_refr=float(scene.default_refr),
        sky_tex=int(scene.sky_tex),
        sky_box=(None if scene.sky_box is None
                 else tuple(int(i) for i in scene.sky_box)),
    )


def uv_map_sphere(d):
    eps = 2.0 ** -52
    u = math.atan2(d[1], d[0]) / (2 * math.pi) + 0.5 - eps
    v = math.atan2(d[2], math.hypot(d[0], d[1])) / math.pi + 0.5 - eps
    return u, v


def _img_hw(s, row):
    # per-image native size (models/textures img_h/img_w columns; the
    # atlas pads to the largest image)
    if s.get("t_h") is not None:
        return int(s["t_h"][row]), int(s["t_w"][row])
    return s["atlas"].shape[1], s["atlas"].shape[2]


def tex_color(s, tex_id: int, u: float, v: float):
    if s["t_kind"][tex_id] == 1:  # IMAGE (nearest)
        atlas = s["atlas"]
        h, w = _img_hw(s, s["t_ref"][tex_id])
        ix = min(max(int(u * w), 0), w - 1)
        iy = min(max(int(v * h), 0), h - 1)
        return atlas[s["t_ref"][tex_id], (h - 1) - iy, ix].copy()
    if s["t_kind"][tex_id] == 2:  # IMAGE_BILINEAR (models/textures.sample)
        atlas = s["atlas"]
        h, w = _img_hw(s, s["t_ref"][tex_id])
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = math.floor(x), math.floor(y)
        fx, fy = x - x0, y - y0
        xi0 = min(max(x0, 0), w - 1)
        xi1 = min(max(x0 + 1, 0), w - 1)
        yi0 = min(max(y0, 0), h - 1)
        yi1 = min(max(y0 + 1, 0), h - 1)
        row = s["t_ref"][tex_id]
        c00 = atlas[row, (h - 1) - yi0, xi0]
        c10 = atlas[row, (h - 1) - yi0, xi1]
        c01 = atlas[row, (h - 1) - yi1, xi0]
        c11 = atlas[row, (h - 1) - yi1, xi1]
        return ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
                + (1 - fx) * fy * c01 + fx * fy * c11)
    return s["t_solid"][tex_id].copy()


def sky_color_scalar(s, d):
    """Sky sample for a direction — equirect, or cube map when sky_box is
    set (mirrors ops/trace.sky_color's face convention exactly)."""
    if s["sky_box"] is None:
        u, v = uv_map_sphere(d)
        return tex_color(s, s["sky_tex"], u, v)
    x, y, z = float(d[0]), float(d[1]), float(d[2])
    ax, ay, az = abs(x), abs(y), abs(z)
    m = max(ax, ay, az, 1e-20)
    if ax >= ay and ax >= az:
        face, sc, tc = (0, -z, -y) if x >= 0 else (1, z, -y)
    elif ay >= az:
        face, sc, tc = (2, x, z) if y >= 0 else (3, x, -z)
    else:
        face, sc, tc = (4, x, -y) if z >= 0 else (5, -x, -y)
    eps = 2.0 ** -23
    u = min(max(0.5 * (sc / m + 1.0), 0.0), 1.0 - eps)
    v = min(max(0.5 * (tc / m + 1.0), 0.0), 1.0 - eps)
    return tex_color(s, s["sky_box"][face], u, v)


# --- intersections (first forward param, matching ops/intersect) -----------

def hit_sphere(org, dir, c, r) -> float:
    oc = org - c
    b_half = float(np.dot(oc, dir))
    a = float(np.dot(dir, dir))
    cc = float(np.dot(oc, oc)) - r * r
    disc = b_half * b_half - a * cc
    if disc < 0:
        return _INF
    sq = math.sqrt(disc)
    t_near = (-b_half - sq) / a
    t_far = (-b_half + sq) / a
    if t_near >= 0:
        return t_near
    if t_far >= 0:
        return t_far
    return _INF


def _slab(org, dir, lo, hi):
    eps = 1e-12
    t0s, t1s = [], []
    for k in range(3):
        d = dir[k]
        if abs(d) < eps:
            d = -eps if d < 0 else eps
        ta = (lo[k] - org[k]) / d
        tb = (hi[k] - org[k]) / d
        t0s.append(min(ta, tb))
        t1s.append(max(ta, tb))
    t_enter = max(t0s)
    t_exit = min(t1s)
    return t_enter, t_exit, int(np.argmax(t0s)), int(np.argmin(t1s))


def hit_box(org, dir, c, h) -> float:
    t_enter, t_exit, _, _ = _slab(org, dir, c - h, c + h)
    if t_enter > t_exit:
        return _INF
    if t_enter >= 0:
        return t_enter
    if t_exit >= 0:
        return t_exit
    return _INF


MT_EPS = 1e-9


def hit_tri(org, dir, v0, v1, v2) -> float:
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(dir, e2)
    det = float(np.dot(e1, p))
    if abs(det) < MT_EPS:
        return _INF
    inv = 1.0 / det
    sv = org - v0
    u = float(np.dot(sv, p)) * inv
    q = np.cross(sv, e1)
    v = float(np.dot(dir, q)) * inv
    t = float(np.dot(e2, q)) * inv
    if u >= 0 and v >= 0 and u + v <= 1 and t >= 0:
        return t
    return _INF


def nearest_hit(s, org, dir) -> Tuple[float, int]:
    best_t, best = _INF, -1
    pid = 0
    for k in range(len(s["sr"])):
        t = hit_sphere(org, dir, s["sc"][k], s["sr"][k])
        if t < best_t:
            best_t, best = t, pid
        pid += 1
    for k in range(len(s["bc"])):
        t = hit_box(org, dir, s["bc"][k], s["bh"][k])
        if t < best_t:
            best_t, best = t, pid
        pid += 1
    for k in range(len(s["t0"])):
        t = hit_tri(org, dir, s["t0"][k], s["t1"][k], s["t2"][k])
        if t < best_t:
            best_t, best = t, pid
        pid += 1
    return best_t, best


def surface(s, org, dir, pid):
    """(point, normal, u, v, t) for the chosen primitive."""
    n_s = len(s["sr"])
    n_b = len(s["bc"])
    if pid < n_s:
        c, r = s["sc"][pid], s["sr"][pid]
        t = hit_sphere(org, dir, c, r)
        point = org + t * dir
        normal = (point - c) / r
        if np.dot(dir, normal) > 0:
            normal = -normal
        u, v = uv_map_sphere(point - c)
        return point, normal, u, v, t
    if pid < n_s + n_b:
        k = pid - n_s
        c, h = s["bc"][k], s["bh"][k]
        lo, hi = c - h, c + h
        t_enter, t_exit, a_in, a_out = _slab(org, dir, lo, hi)
        entering = t_enter >= 0
        t = t_enter if entering else t_exit
        axis = a_in if entering else a_out
        point = org + t * dir
        sign = math.copysign(1.0, dir[axis]) if dir[axis] != 0 else 1.0
        normal = np.zeros(3)
        normal[axis] = -sign
        outward = -sign if entering else sign
        face = axis * 2 + (1 if outward > 0 else 0)
        rel = np.clip((point - lo) / (2 * h), 0.0, 1.0 - 2.0 ** -23)
        b_axis = 1 if axis == 0 else 0
        c_axis = 1 if axis == 2 else 2
        u = (face + rel[b_axis]) / 6.0
        return point, normal, u, rel[c_axis], t
    k = pid - n_s - n_b
    v0, v1, v2 = s["t0"][k], s["t1"][k], s["t2"][k]
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(dir, e2)
    det = float(np.dot(e1, p))
    inv = 1.0 / (MT_EPS if abs(det) < MT_EPS else det)
    sv = org - v0
    u = float(np.dot(sv, p)) * inv
    q = np.cross(sv, e1)
    v = float(np.dot(dir, q)) * inv
    t = float(np.dot(e2, q)) * inv
    point = org + t * dir
    normal = np.cross(e1, e2)
    normal = normal / (np.linalg.norm(normal) + 1e-300)
    if np.dot(dir, normal) > 0:
        normal = -normal
    return point, normal, u, v, t


def substance_refr_at(s, point, cur_refr):
    """Innermost containing entity's substance (trace.py contract)."""
    best_vol, best_pid = _INF, -1
    pid = 0
    for k in range(len(s["sr"])):
        if np.sum((point - s["sc"][k]) ** 2) <= s["sr"][k] ** 2:
            vol = (4.0 / 3.0) * math.pi * s["sr"][k] ** 3
            if vol < best_vol:
                best_vol, best_pid = vol, pid
        pid += 1
    for k in range(len(s["bc"])):
        if np.all(np.abs(point - s["bc"][k]) <= s["bh"][k]):
            vol = float(np.prod(2 * s["bh"][k]))
            if vol < best_vol:
                best_vol, best_pid = vol, pid
        pid += 1
    if best_pid < 0:
        return s["default_refr"], True
    sub_id = s["sub"][best_pid]
    if sub_id < 0:
        return cur_refr, False
    return float(s["sub_refr"][sub_id]), True


def reflect(d, n):
    return d - 2.0 * float(np.dot(d, n)) * n


def refract(d, n, eta):
    c1 = -float(np.dot(d, n))
    s2 = eta * eta * (1.0 - c1 * c1)
    if s2 > 1.0:
        return reflect(d, n)
    c2 = math.sqrt(1.0 - s2)
    return eta * d + (eta * c1 - c2) * n


def trace_ray(s, org, dir, refmax, atten, start_refr, rng=None,
              fresnel_both=False):
    """Scalar twin of ops/trace.trace_rays for one ray.

    ``rng = (seed, rid)`` enables the exact counter-RNG scatter for rough
    materials (identical streams to every backend); without it rough
    materials raise. Returns (color[3], status, path)."""
    org = np.array(org, np.float64)
    dir = np.array(dir, np.float64)
    color = np.ones(3)
    path = 0.0
    refr = float(start_refr)
    status = int(RayStatus.ALIVE)

    for _bounce in range(refmax):
        t, pid = nearest_hit(s, org, dir)
        if pid < 0:
            color = color * sky_color_scalar(s, dir)
            status = int(RayStatus.MISS)
            break
        point, normal, u, v, t = surface(s, org, dir, pid)
        color = color * tex_color(s, int(s["tex"][pid]), u, v)
        path += t
        mid = int(s["mat"][pid])
        if s["m_light"][mid]:
            status = int(RayStatus.LIGHT)
            break
        resp = int(s["m_resp"][mid])
        if resp == int(ResponseType.REFLECTION):
            if not s["m_mirror"][mid]:
                status = int(RayStatus.KEEP)
                break
            rough = float(s["m_rough"][mid])
            if rough > 0 and rng is None:
                raise NotImplementedError(
                    "rough materials need rng=(seed, rid) for the "
                    "counter-hash scatter draw")
            dir = reflect(dir, normal)
            if rough > 0:
                dir = _scatter_direction(rng[0], rng[1], _bounce, dir,
                                         normal, rough)
            org = point + EPS_ADVANCE * dir
        elif resp == int(ResponseType.TRANSMISSION):
            adv = point + EPS_ADVANCE * dir
            target, do_refract = substance_refr_at(s, adv, refr)
            if do_refract:
                dir = refract(dir, normal, refr / max(target, 1e-6))
                refr = target
            org = adv
        elif fresnel_both:  # BOTH — Fresnel-split EXTENSION (twin of
            # ops/trace._bounce; the reference default-returns instead,
            # raytracer.ts:250-251). Same counter-RNG draw coordinates.
            adv = point + EPS_ADVANCE * dir
            target, do_refract = substance_refr_at(s, adv, refr)
            n2 = max(float(target), 1e-6)
            c1 = -float(np.dot(dir, normal))
            eta = refr / n2
            tir = eta * eta * (1.0 - c1 * c1) > 1.0
            if not do_refract:
                fres = 0.0
            elif tir:
                fres = 1.0
            else:
                r0 = ((refr - n2) / (refr + n2)) ** 2
                cos_i = min(max(abs(c1), 0.0), 1.0)
                fres = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
            if rng is None:
                raise NotImplementedError(
                    "fresnel_both needs rng=(seed, rid) for the "
                    "counter-hash Fresnel draw")
            u_f = _uniform(rng[0], rng[1], _bounce, _SALT_FRESNEL)
            if u_f < fres:
                dir = reflect(dir, normal)
                rough = float(s["m_rough"][mid])
                if rough > 0:
                    dir = _scatter_direction(rng[0], rng[1], _bounce, dir,
                                             normal, rough)
                org = point + EPS_ADVANCE * dir
            else:
                if do_refract:
                    dir = refract(dir, normal, eta)
                    refr = float(target)
                org = adv
        else:  # BOTH — unhandled in the reference (raytracer.ts:250-251)
            status = int(RayStatus.KEEP)
            break

    if status == int(RayStatus.ALIVE):
        color = np.zeros(3)
        status = int(RayStatus.EXHAUST)
    if status == int(RayStatus.LIGHT):
        color = color / (JS_EPSILON + (path * atten) ** 2)
    return color, status, path


def camera_dirs(pos, front, left, up, fov_h, fov_v, w, h):
    """Scalar twin of models/camera.pixel_rays (closed-form equiangular)."""
    front = np.asarray(front, np.float64)
    left = np.asarray(left, np.float64)
    up = np.asarray(up, np.float64)
    dirs = np.zeros((h, w, 3))
    for y in range(h):
        th_v = (y - (h // 2)) * (fov_v / h)
        cv, sv = math.cos(th_v), math.sin(th_v)
        for x in range(w):
            th_h = (x - (w // 2)) * (fov_h / w)
            ch, sh = math.cos(th_h), math.sin(th_h)
            dirs[y, x] = ch * cv * front + ch * sv * up + sh * left
    return dirs


def render(scene, camera, cfg, seed: Optional[int] = None) -> np.ndarray:
    """Scalar full-frame render -> [h, w, 3] float64 HDR.

    ``seed`` (the uint32 from ops.sampling.seed_from_key) enables rough
    scenes; ray id = pixel y*w + x (spp 1), matching render.render_rays.
    """
    s = _as_np(scene)
    pos = np.asarray(camera.pos, np.float64)
    dirs = camera_dirs(pos, camera.front, camera.left, camera.up,
                       camera.fov_h, camera.fov_v, camera.w, camera.h)
    start_refr, _ = substance_refr_at(s, pos, s["default_refr"])
    img = np.zeros((camera.h, camera.w, 3))
    for y in range(camera.h):
        for x in range(camera.w):
            rng = (seed, y * camera.w + x) if seed is not None else None
            color, _, _ = trace_ray(s, pos, dirs[y, x], cfg.refmax,
                                    cfg.distance_attenuation_factor,
                                    start_refr, rng=rng,
                                    fresnel_both=getattr(
                                        cfg, "fresnel_both", False))
            img[y, x] = color
    return img
