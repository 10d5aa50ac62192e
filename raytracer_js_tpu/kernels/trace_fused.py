"""Whole-trace ray kernel (Pallas, Triton route).

The bounce loop of :func:`raytracer_js_tpu.ops.trace.trace_rays` for the
scene class :func:`supports` admits, run inside one kernel launch. Each
program traces a 1-D block of ``BLOCK`` rays with one ray per thread; the
ray state (origin, direction, color, path, status, substance) stays in
registers across bounces, and primitives are read by scalar loads from small
per-class tables that stay in L1/L2. The dense XLA path instead writes
``[N, P]`` hit matrices and per-bounce ray state to device memory.

Two entry points share the kernel body:

- :func:`trace_rays_fused` — a wavefront of rays in, colors and statuses out.
- :func:`trace_frame_fused` — a whole frame; rays are generated inside the
  kernel from the pixel index and per-row / per-column angle tables
  (:func:`raytracer_js_tpu.models.camera.angle_tables`, the same terms as
  ``pixel_rays``), so no ray tensor exists in device memory.

Every formula is written term for term like the XLA path it replaces
(``ops/intersect`` hit tests and surface recompute, ``ops/trace._bounce``
shading, ``ops/trace.substance_refr_at``, ``ops/sampling`` scatter), so the
two agree to rounding. Division is IEEE round-to-nearest (``div.rn.f32``):
Triton lowers ``/`` to the approximate ``div.full.f32``.

Semantics (raytracer.ts:166-277): hit -> color *= prim rgb, path += t;
emissive -> LIGHT with the inverse-square law at the end; mirror REFLECTION
-> reflect (+ roughness scatter) and eps-advance; TRANSMISSION -> eps-advance,
innermost-containment substance, Snell with TIR; non-mirror -> KEEP;
miss -> color *= sky, MISS; refmax exhaustion -> black EXHAUST.

On the CPU the kernel runs in the Pallas interpreter (tests); on a GPU it
compiles through Triton; any other backend raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import EPS_ADVANCE, JS_EPSILON, RayStatus, RenderConfig, ResponseType
from ..models.camera import angle_tables
from ..models.scene import Scene, prim_volumes
from ..ops import sampling
from ..ops.intersect import MT_EPS, SLAB_DIR_EPS
from ..ops.vecmath import normalize

Array = jnp.ndarray

#: rays per program (one per thread at NUM_WARPS warps of 32 threads)
BLOCK = 128
NUM_WARPS = 4

_INF = float("inf")
_ALIVE = int(RayStatus.ALIVE)
_LIGHT = int(RayStatus.LIGHT)
_KEEP = int(RayStatus.KEEP)
_MISS = int(RayStatus.MISS)
_EXHAUST = int(RayStatus.EXHAUST)

# Per-class table columns (row-major [n, COLS], flattened). ``mode`` packs
# the response: 0 keep, 1 mirror continuation, 2 emissive, 3 transmission.
# ``refr`` is the substance index (-1 = undefined), ``vol`` the enclosed
# volume of the innermost-containment rule.
S_C, S_R, S_R2, S_RGB, S_MODE, S_ROUGH, S_REFR, S_VOL, S_COLS = (
    0, 3, 4, 5, 8, 9, 10, 11, 12)
B_LO, B_HI, B_C, B_H, B_RGB, B_MODE, B_ROUGH, B_REFR, B_VOL, B_COLS = (
    0, 3, 6, 9, 12, 15, 16, 17, 18, 19)
T_V0, T_E1, T_E2, T_N, T_RGB, T_MODE, T_ROUGH, T_COLS = (
    0, 3, 6, 9, 12, 15, 16, 17)

# scalar parameter slots (f32 / i32 vectors read by scalar loads)
_F_SKY, _F_REFR0, _F_REFR_DEF, _F_POS, _F_FRONT, _F_LEFT, _F_UP = (
    0, 3, 4, 5, 8, 11, 14)
_F_LEN = 17
_I_SEED, _I_SPP, _I_SAMPLE = 0, 1, 2
_I_LEN = 3


class Meta(NamedTuple):
    """Static description of one kernel instance."""
    n_sph: int
    n_box: int
    n_tri: int
    refmax: int
    atten: float
    has_rough: bool
    has_trans: bool
    exact_div: bool       # inline div.rn.f32 (compiled) vs ``/`` (interpreter)


def supports(scene: Scene) -> bool:
    """Scenes the kernel traces: solid textures and a solid sky sphere,
    no ResponseType.BOTH. Image textures, sky boxes and BOTH scenes render
    on the XLA path (render.py routes them to BRUTE)."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_both)


def use_interpreter() -> bool:
    """True on the CPU (tests run the kernel in the Pallas interpreter),
    False on a GPU (compiled through Triton); other backends raise."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"trace_fused has no kernel route for backend {backend!r}")


# ---------------------------------------------------------------------------
# kernel body
# ---------------------------------------------------------------------------

def _div(x, y, exact: bool):
    """x / y, correctly rounded on the GPU (see module docstring)."""
    if not exact:
        return x / y
    x, y = jnp.broadcast_arrays(jnp.asarray(x, jnp.float32),
                                jnp.asarray(y, jnp.float32))
    return pltriton.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[x, y], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape,
                                                          jnp.float32)])[0]


def _ld3(ref, base, col):
    return ref[base + col], ref[base + col + 1], ref[base + col + 2]


def _trace(o, d, rid, f_ref, i_ref, s_ref, b_ref, t_ref, m: Meta):
    """Trace one block of rays -> (r, g, b, status) planes.

    ``o`` is a triple of scalars (shared origin) or of [BLOCK] planes; ``d``
    a triple of [BLOCK] planes. Tables are flat refs read by scalar loads
    (search) and per-ray gathers (winner attributes)."""
    div = functools.partial(_div, exact=m.exact_div)
    shape = d[0].shape
    f32 = jnp.float32
    sky = _ld3(f_ref, 0, _F_SKY)
    seed = (i_ref[_I_SEED].astype(jnp.uint32) if m.has_rough else None)
    refr_def = f_ref[_F_REFR_DEF]
    s_end, b_end = m.n_sph, m.n_sph + m.n_box

    def safe_inv(v):
        v = jnp.where(jnp.abs(v) < SLAB_DIR_EPS,
                      jnp.where(v < 0, -SLAB_DIR_EPS, SLAB_DIR_EPS), v)
        return div(1.0, v)

    def bounce(state, b_idx):
        (ox, oy, oz), (dx, dy, dz), (cr, cg, cb), path, status, refr = state
        alive = status == _ALIVE
        a = dx * dx + dy * dy + dz * dz
        inv_a = div(1.0, a)
        ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)

        # ---- nearest forward hit (ops/intersect *_hit_t, first minimum) --
        def sph_hit(p, best):
            bt, bp = best
            base = p * S_COLS
            cx, cy, cz = _ld3(s_ref, base, S_C)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            bh = ocx * dx + ocy * dy + ocz * dz
            c = (ocx * ocx + ocy * ocy + ocz * ocz) - s_ref[base + S_R2]
            disc = bh * bh - a * c
            valid = disc >= 0.0
            sq = jnp.sqrt(jnp.where(valid, disc, 0.0))
            tn = (-bh - sq) * inv_a
            tf = (-bh + sq) * inv_a
            t = jnp.where(tn >= 0.0, tn, jnp.where(tf >= 0.0, tf, _INF))
            u = valid & (t < bt)
            return jnp.where(u, t, bt), jnp.where(u, p, bp)

        def box_hit(p, best):
            bt, bp = best
            base = p * B_COLS
            lx, ly, lz = _ld3(b_ref, base, B_LO)
            hx, hy, hz = _ld3(b_ref, base, B_HI)
            t_in, t_out = _slab(ox, oy, oz, ix, iy, iz, lx, ly, lz,
                                hx, hy, hz)[:2]
            t = jnp.where(t_in >= 0.0, t_in,
                          jnp.where(t_out >= 0.0, t_out, _INF))
            u = (t_in <= t_out) & (t < bt)
            return jnp.where(u, t, bt), jnp.where(u, p + s_end, bp)

        def tri_hit(p, best):
            bt, bp = best
            t, ok = _moller_trumbore(t_ref, p * T_COLS, ox, oy, oz,
                                     dx, dy, dz, div)
            u = ok & (t < bt)
            return jnp.where(u, t, bt), jnp.where(u, p + b_end, bp)

        best = (jnp.full(shape, _INF, f32), jnp.full(shape, -1, jnp.int32))
        for n, body in ((m.n_sph, sph_hit), (m.n_box, box_hit),
                        (m.n_tri, tri_hit)):
            if n:
                best = jax.lax.fori_loop(0, n, body, best)
        _t_best, pid = best

        # ---- winner surface (ops/intersect *_surface, one per class) ----
        zero = jnp.zeros(shape, f32)
        px = py = pz = nx = ny = nz = t_s = zero
        rgb = (zero, zero, zero)
        mode = rough = zero
        if m.n_sph:
            base = jnp.clip(pid, 0, m.n_sph - 1) * S_COLS
            cx, cy, cz = _ld3(s_ref, base, S_C)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            bh = ocx * dx + ocy * dy + ocz * dz
            c = (ocx * ocx + ocy * ocy + ocz * ocz) - s_ref[base + S_R2]
            disc = bh * bh - a * c
            pos = disc > 0.0
            sq = jnp.sqrt(jnp.where(pos, disc, 1.0)) * pos.astype(f32)
            tn = div(-bh - sq, a)
            t = jnp.where(tn >= 0.0, tn, div(-bh + sq, a))
            qx, qy, qz = ox + t * dx, oy + t * dy, oz + t * dz
            r = s_ref[base + S_R]
            r = jnp.where(jnp.abs(r) < 1e-12, 1e-12, r)
            sx, sy, sz = div(qx - cx, r), div(qy - cy, r), div(qz - cz, r)
            flip = (dx * sx + dy * sy + dz * sz) > 0.0
            sx, sy, sz = (jnp.where(flip, -sx, sx), jnp.where(flip, -sy, sy),
                          jnp.where(flip, -sz, sz))
            m_s = pid < s_end
            px, py, pz = (jnp.where(m_s, qx, px), jnp.where(m_s, qy, py),
                          jnp.where(m_s, qz, pz))
            nx, ny, nz = (jnp.where(m_s, sx, nx), jnp.where(m_s, sy, ny),
                          jnp.where(m_s, sz, nz))
            t_s = jnp.where(m_s, t, t_s)
            rgb = tuple(jnp.where(m_s, v, w)
                        for v, w in zip(_ld3(s_ref, base, S_RGB), rgb))
            mode = jnp.where(m_s, s_ref[base + S_MODE], mode)
            if m.has_rough:
                rough = jnp.where(m_s, s_ref[base + S_ROUGH], rough)
        if m.n_box:
            base = jnp.clip(pid - s_end, 0, m.n_box - 1) * B_COLS
            lx, ly, lz = _ld3(b_ref, base, B_LO)
            hx, hy, hz = _ld3(b_ref, base, B_HI)
            t_in, t_out, (e0, e1, _e2), (x0, x1, _x2) = _slab(
                ox, oy, oz, ix, iy, iz, lx, ly, lz, hx, hy, hz)
            entering = t_in >= 0.0
            t = jnp.where(entering, t_in, t_out)
            a0 = jnp.where(entering, e0, x0)
            a1 = jnp.where(entering, e1, x1) & ~a0
            a2 = ~(a0 | a1)
            a0, a1, a2 = a0.astype(f32), a1.astype(f32), a2.astype(f32)
            d_axis = dx * a0 + dy * a1 + dz * a2
            sign = jnp.where(d_axis < 0.0, -1.0, 1.0)
            m_b = (pid >= s_end) & (pid < b_end)
            px = jnp.where(m_b, ox + t * dx, px)
            py = jnp.where(m_b, oy + t * dy, py)
            pz = jnp.where(m_b, oz + t * dz, pz)
            nx = jnp.where(m_b, -sign * a0, nx)
            ny = jnp.where(m_b, -sign * a1, ny)
            nz = jnp.where(m_b, -sign * a2, nz)
            t_s = jnp.where(m_b, t, t_s)
            rgb = tuple(jnp.where(m_b, v, w)
                        for v, w in zip(_ld3(b_ref, base, B_RGB), rgb))
            mode = jnp.where(m_b, b_ref[base + B_MODE], mode)
            if m.has_rough:
                rough = jnp.where(m_b, b_ref[base + B_ROUGH], rough)
        if m.n_tri:
            base = jnp.clip(pid - b_end, 0, m.n_tri - 1) * T_COLS
            t, _ok = _moller_trumbore(t_ref, base, ox, oy, oz, dx, dy, dz,
                                      div)
            gx, gy, gz = _ld3(t_ref, base, T_N)
            flip = (dx * gx + dy * gy + dz * gz) > 0.0
            m_t = pid >= b_end
            px = jnp.where(m_t, ox + t * dx, px)
            py = jnp.where(m_t, oy + t * dy, py)
            pz = jnp.where(m_t, oz + t * dz, pz)
            nx = jnp.where(m_t, jnp.where(flip, -gx, gx), nx)
            ny = jnp.where(m_t, jnp.where(flip, -gy, gy), ny)
            nz = jnp.where(m_t, jnp.where(flip, -gz, gz), nz)
            t_s = jnp.where(m_t, t, t_s)
            rgb = tuple(jnp.where(m_t, v, w)
                        for v, w in zip(_ld3(t_ref, base, T_RGB), rgb))
            mode = jnp.where(m_t, t_ref[base + T_MODE], mode)
            if m.has_rough:
                rough = jnp.where(m_t, t_ref[base + T_ROUGH], rough)

        # ---- shading (ops/trace._bounce) ---------------------------------
        hit = alive & (pid >= 0)
        miss = alive & (pid < 0)
        cr = jnp.where(hit, cr * rgb[0], cr)
        cg = jnp.where(hit, cg * rgb[1], cg)
        cb = jnp.where(hit, cb * rgb[2], cb)
        path = jnp.where(hit, path + t_s, path)
        is_light = hit & (mode == 2.0)
        cont_m = hit & (mode == 1.0)
        cont_t = (hit & (mode == 3.0)) if m.has_trans else None

        dn = dx * nx + dy * ny + dz * nz
        rdx = dx - 2.0 * dn * nx
        rdy = dy - 2.0 * dn * ny
        rdz = dz - 2.0 * dn * nz
        if m.has_rough:
            sdx, sdy, sdz = sampling.scatter_direction_xyz(
                seed, rid, b_idx, rdx, rdy, rdz, nx, ny, nz, rough, div=div)
        else:
            sdx, sdy, sdz = rdx, rdy, rdz
        new_o = [jnp.where(cont_m, q + EPS_ADVANCE * s, o_)
                 for q, s, o_ in ((px, sdx, ox), (py, sdy, oy),
                                  (pz, sdz, oz))]
        new_d = [jnp.where(cont_m, s, v)
                 for s, v in ((sdx, dx), (sdy, dy), (sdz, dz))]
        if m.has_trans:
            adv = (px + EPS_ADVANCE * dx, py + EPS_ADVANCE * dy,
                   pz + EPS_ADVANCE * dz)
            target, do_refract = _substance(adv, refr, refr_def, s_ref,
                                            b_ref, m, shape)
            eta = div(refr, jnp.maximum(target, 1e-6))
            # ops/vecmath.refract, term for term
            c1 = -dn
            s2 = (eta * eta) * (1.0 - c1 * c1)
            tir = s2 > 1.0
            inside = jnp.maximum(1.0 - s2, 0.0)
            pos = inside > 0.0
            c2 = jnp.sqrt(jnp.where(pos, inside, 1.0)) * pos.astype(f32)
            k = eta * c1 - c2
            for i, (v, nv, rv, av) in enumerate(
                    ((dx, nx, rdx, adv[0]), (dy, ny, rdy, adv[1]),
                     (dz, nz, rdz, adv[2]))):
                refracted = jnp.where(tir, rv, eta * v + k * nv)
                trans = jnp.where(do_refract, refracted, v)
                new_d[i] = jnp.where(cont_t, trans, new_d[i])
                new_o[i] = jnp.where(cont_t, av, new_o[i])
            refr = jnp.where(cont_t,
                             jnp.where(do_refract, target, refr), refr)
            cont = cont_m | cont_t
        else:
            cont = cont_m

        cr = jnp.where(miss, cr * sky[0], cr)
        cg = jnp.where(miss, cg * sky[1], cg)
        cb = jnp.where(miss, cb * sky[2], cb)
        keep = hit & ~is_light & ~cont
        status = jnp.where(is_light, _LIGHT, status)
        status = jnp.where(keep, _KEEP, status)
        status = jnp.where(miss, _MISS, status)
        return (tuple(new_o), tuple(new_d), (cr, cg, cb), path, status,
                refr)

    one = jnp.ones(shape, f32)
    refr0 = (jnp.broadcast_to(f_ref[_F_REFR0], shape) if m.has_trans
             else jnp.zeros(shape, f32))
    state = (o, d, (one, one, one), jnp.zeros(shape, f32),
             jnp.full(shape, _ALIVE, jnp.int32), refr0)
    for b_idx in range(m.refmax):
        if b_idx == 0:
            state = bounce(state, b_idx)
        else:
            # skip the whole bounce when no ray of the block is alive
            any_alive = jnp.max((state[4] == _ALIVE).astype(jnp.int32)) > 0
            state = jax.lax.cond(
                any_alive, lambda s, b=b_idx: bounce(s, b), lambda s: s,
                state)
    _o, _d, (cr, cg, cb), path, status, _refr = state

    # refmax exhaustion -> black; inverse-square law for light hits
    exhausted = status == _ALIVE
    status = jnp.where(exhausted, _EXHAUST, status)
    pa = path * m.atten
    isl = div(1.0, JS_EPSILON + pa * pa)
    lit = status == _LIGHT
    out = []
    for ch in (cr, cg, cb):
        ch = jnp.where(exhausted, 0.0, ch)
        out.append(jnp.where(lit, ch * isl, ch))
    return (*out, status)


def _slab(ox, oy, oz, ix, iy, iz, lx, ly, lz, hx, hy, hz):
    """Liang-Barsky slabs (ops/intersect._slab) -> (t_enter, t_exit,
    first-argmax masks of the entry axis, first-argmin masks of the exit
    axis)."""
    tax, tbx = (lx - ox) * ix, (hx - ox) * ix
    tay, tby = (ly - oy) * iy, (hy - oy) * iy
    taz, tbz = (lz - oz) * iz, (hz - oz) * iz
    t0x, t1x = jnp.minimum(tax, tbx), jnp.maximum(tax, tbx)
    t0y, t1y = jnp.minimum(tay, tby), jnp.maximum(tay, tby)
    t0z, t1z = jnp.minimum(taz, tbz), jnp.maximum(taz, tbz)
    t_in = jnp.maximum(jnp.maximum(t0x, t0y), t0z)
    t_out = jnp.minimum(jnp.minimum(t1x, t1y), t1z)
    ex = t0x == t_in
    ey = ~ex & (t0y == t_in)
    xx = t1x == t_out
    xy = ~xx & (t1y == t_out)
    return t_in, t_out, (ex, ey, ~(ex | ey)), (xx, xy, ~(xx | xy))


def _moller_trumbore(t_ref, base, ox, oy, oz, dx, dy, dz, div):
    """ops/intersect.tri_hit_t for one triangle row -> (t, valid)."""
    v0x, v0y, v0z = _ld3(t_ref, base, T_V0)
    e1x, e1y, e1z = _ld3(t_ref, base, T_E1)
    e2x, e2y, e2z = _ld3(t_ref, base, T_E2)
    qx_ = dy * e2z - dz * e2y
    qy_ = dz * e2x - dx * e2z
    qz_ = dx * e2y - dy * e2x
    det = e1x * qx_ + e1y * qy_ + e1z * qz_
    inv_det = div(1.0, jnp.where(jnp.abs(det) < MT_EPS, MT_EPS, det))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * qx_ + sy * qy_ + sz * qz_) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((jnp.abs(det) >= MT_EPS) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return t, ok


def _substance(pt, refr, refr_def, s_ref, b_ref, m: Meta, shape):
    """ops/trace.substance_refr_at (dense): innermost containing entity's
    substance -> (target refractive index, do_refract)."""
    ax, ay, az = pt

    def upd(acc, inside, vol, rf):
        vol_min, sel, any_in = acc
        u = inside & (vol < vol_min)
        return (jnp.where(u, vol, vol_min), jnp.where(u, rf, sel),
                any_in | inside)

    def sph(p, acc):
        base = p * S_COLS
        cx, cy, cz = _ld3(s_ref, base, S_C)
        ex, ey, ez = ax - cx, ay - cy, az - cz
        inside = (ex * ex + ey * ey + ez * ez) <= s_ref[base + S_R2]
        return upd(acc, inside, s_ref[base + S_VOL], s_ref[base + S_REFR])

    def box(p, acc):
        base = p * B_COLS
        cx, cy, cz = _ld3(b_ref, base, B_C)
        hx, hy, hz = _ld3(b_ref, base, B_H)
        inside = ((jnp.abs(ax - cx) <= hx) & (jnp.abs(ay - cy) <= hy)
                  & (jnp.abs(az - cz) <= hz))
        return upd(acc, inside, b_ref[base + B_VOL], b_ref[base + B_REFR])

    acc = (jnp.full(shape, _INF, jnp.float32),
           jnp.full(shape, -1.0, jnp.float32), jnp.zeros(shape, bool))
    if m.n_sph:
        acc = jax.lax.fori_loop(0, m.n_sph, sph, acc)
    if m.n_box:
        acc = jax.lax.fori_loop(0, m.n_box, box, acc)
    _vol, sel, any_in = acc
    defined = sel >= 0.0
    target = jnp.where(any_in, jnp.where(defined, sel, refr), refr_def)
    return target, (~any_in) | defined


def _wavefront_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                      rid_ref, f_ref, i_ref, s_ref, b_ref, t_ref,
                      r_out, g_out, b_out, st_out, *, meta: Meta):
    rid = rid_ref[...] if meta.has_rough else None
    outs = _trace((ox_ref[...], oy_ref[...], oz_ref[...]),
                  (dx_ref[...], dy_ref[...], dz_ref[...]), rid,
                  f_ref, i_ref, s_ref, b_ref, t_ref, meta)
    for ref, v in zip((r_out, g_out, b_out, st_out), outs):
        ref[...] = v


def _frame_kernel(ch_ref, sh_ref, cv_ref, sv_ref, f_ref, i_ref, s_ref,
                  b_ref, t_ref, r_out, g_out, b_out, st_out, *, meta: Meta,
                  w: int, n_pix: int):
    """Rays from the pixel index: k = y * w + x, direction as in
    models/camera.pixel_rays from the (cos, sin) angle tables."""
    k = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    kc = jnp.minimum(k, n_pix - 1)          # padded lanes repeat a pixel
    x = jax.lax.rem(kc, w)
    y = jax.lax.div(kc, w)
    ch, sh = ch_ref[x], sh_ref[x]
    cv, sv = cv_ref[y], sv_ref[y]
    a1, a2 = ch * cv, ch * sv
    fr, lf, up = (_ld3(f_ref, 0, _F_FRONT), _ld3(f_ref, 0, _F_LEFT),
                  _ld3(f_ref, 0, _F_UP))
    d = tuple(a1 * fr[i] + a2 * up[i] + sh * lf[i] for i in range(3))
    rid = (kc * i_ref[_I_SPP] + i_ref[_I_SAMPLE]) if meta.has_rough else None
    outs = _trace(_ld3(f_ref, 0, _F_POS), d, rid, f_ref, i_ref, s_ref,
                  b_ref, t_ref, meta)
    for ref, v in zip((r_out, g_out, b_out, st_out), outs):
        ref[...] = v


def _call(kernel, n_pad, args, n_blocked, interpret):
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[ray] * n_blocked + [anywhere] * (len(args) - n_blocked),
        out_specs=[ray] * 4,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((n_pad,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="trace_fused",
    )(*args)


@functools.partial(jax.jit, static_argnames=("meta", "interpret"))
def _wavefront_call(cols, rid, fpar, ipar, sph, box, tri, meta, interpret):
    kern = functools.partial(_wavefront_kernel, meta=meta)
    return _call(kern, rid.shape[0], (*cols, rid, fpar, ipar, sph, box, tri),
                 7, interpret)


@functools.partial(jax.jit, static_argnames=("meta", "w", "n_pix",
                                             "interpret"))
def _frame_call(tabs, fpar, ipar, sph, box, tri, meta, w, n_pix, interpret):
    kern = functools.partial(_frame_kernel, meta=meta, w=w, n_pix=n_pix)
    n_pad = -(-n_pix // BLOCK) * BLOCK
    return _call(kern, n_pad, (*tabs, fpar, ipar, sph, box, tri), 0,
                 interpret)


# ---------------------------------------------------------------------------
# host-side packing
# ---------------------------------------------------------------------------

def _pack_prims(scene: Scene):
    """Flat per-class tables (column layouts above) from the scene."""
    f32 = jnp.float32
    mat = scene.materials
    pm = scene.prim_material
    light = mat.light[pm]
    response = mat.response[pm]
    mode = jnp.where(
        light, 2.0,
        jnp.where(mat.mirror[pm] & (response == int(ResponseType.REFLECTION)),
                  1.0,
                  jnp.where(response == int(ResponseType.TRANSMISSION)
                            & scene.has_transmission, 3.0, 0.0))).astype(f32)
    rgb = scene.textures.solid_rgb[scene.prim_texture].astype(f32)
    rough = mat.roughness[pm].astype(f32)
    sub = scene.prim_substance
    sref = jnp.where(
        sub >= 0, scene.sub_refr[jnp.clip(sub, 0, scene.sub_refr.shape[0] - 1)],
        -1.0).astype(f32)
    vol = prim_volumes(scene).astype(f32)
    s_end, b_end = scene.n_spheres, scene.n_spheres + scene.n_boxes

    def attrs(lo, hi):
        return [rgb[lo:hi], mode[lo:hi, None], rough[lo:hi, None]]

    def flat(cols, n):
        if n == 0:
            return jnp.zeros((1,), f32)
        return jnp.concatenate([c.astype(f32) for c in cols], axis=1).reshape(-1)

    r = scene.sphere_radius
    sph = flat([scene.sphere_center, r[:, None], (r ** 2)[:, None],
                *attrs(0, s_end), sref[:s_end, None], vol[:s_end, None]],
               s_end)
    c, h = scene.box_center, scene.box_half
    box = flat([c - h, c + h, c, h, *attrs(s_end, b_end),
                sref[s_end:b_end, None], vol[s_end:b_end, None]],
               scene.n_boxes)
    e1 = scene.tri_v1 - scene.tri_v0
    e2 = scene.tri_v2 - scene.tri_v0
    gn = normalize(jnp.cross(e1, e2), eps=1e-20)      # as tri_surface
    tri = flat([scene.tri_v0, e1, e2, gn, *attrs(b_end, scene.n_prims)],
               scene.n_tris)
    return sph, box, tri


def _meta(scene: Scene, cfg: RenderConfig, interpret: bool) -> Meta:
    return Meta(scene.n_spheres, scene.n_boxes, scene.n_tris,
                int(cfg.refmax), float(cfg.distance_attenuation_factor),
                bool(scene.has_rough), bool(scene.has_transmission),
                not interpret)


def _params(scene, key, start_refr, cam=None, spp=1, sample=0):
    """(f32 params, i32 params) vectors of the kernel's scalar slots."""
    sky = scene.textures.solid_rgb[scene.sky_tex].astype(jnp.float32)
    refr0 = (jnp.asarray(start_refr, jnp.float32) if start_refr is not None
             else scene.default_refr.astype(jnp.float32))
    pose = (jnp.concatenate([cam.pos, cam.front, cam.left, cam.up])
            if cam is not None else jnp.zeros((12,)))
    fpar = jnp.concatenate([sky, refr0.reshape(1),
                            scene.default_refr.reshape(1).astype(jnp.float32),
                            pose.astype(jnp.float32)])
    seed = (sampling.seed_from_key(
        key if key is not None else jax.random.key(0)).astype(jnp.int32)
        if scene.has_rough else jnp.int32(0))
    ipar = jnp.stack([seed, jnp.int32(spp),
                      jnp.asarray(sample, jnp.int32)])
    return fpar, ipar


def trace_rays_fused(scene: Scene, cfg: RenderConfig, org: Array, dir: Array,
                     key: Array | None = None, ray_id: Array | None = None,
                     start_refr: Array | None = None):
    """Fused trace of a ray wavefront -> (color [N, 3], status [N]).

    ``key``/``ray_id`` seed the counter RNG of rough scenes (the same
    streams as the XLA path); ``start_refr`` is the camera substance of
    transmission scenes (default: the scene default). Callers check
    :func:`supports`.
    """
    interpret = use_interpreter()
    n = org.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    if ray_id is None:
        ray_id = jnp.arange(n, dtype=jnp.int32)
    if n_pad != n:
        # edge-replicate the tail; padded outputs are sliced off below
        org = jnp.concatenate(
            [org, jnp.broadcast_to(org[-1], (n_pad - n, 3))], axis=0)
        dir = jnp.concatenate(
            [dir, jnp.broadcast_to(dir[-1], (n_pad - n, 3))], axis=0)
        ray_id = jnp.concatenate(
            [ray_id, jnp.broadcast_to(ray_id[-1], (n_pad - n,))], axis=0)
    cols = tuple(v[:, i].astype(jnp.float32) for v in (org, dir)
                 for i in range(3))
    fpar, ipar = _params(scene, key, start_refr)
    r, g, b, st = _wavefront_call(cols, ray_id.astype(jnp.int32), fpar, ipar,
                                  *_pack_prims(scene),
                                  meta=_meta(scene, cfg, interpret),
                                  interpret=interpret)
    return jnp.stack([r[:n], g[:n], b[:n]], axis=-1), st[:n]


def trace_frame_fused(scene: Scene, cfg: RenderConfig, cam,
                      key: Array | None = None, sample: Array | int = 0,
                      start_refr: Array | None = None) -> Array:
    """Whole frame with in-kernel ray generation -> [h, w, 3] HDR.

    Pixel k = y * w + x traces the ray of ``pixel_rays(cam)[k]``; rough
    scenes draw from stream ``k * spp + sample``, as render.render_rays
    does. Callers check :func:`supports`.
    """
    interpret = use_interpreter()
    n_pix = cam.w * cam.h
    fpar, ipar = _params(scene, key, start_refr, cam=cam, spp=cfg.spp,
                         sample=sample)
    r, g, b, _st = _frame_call(angle_tables(cam), fpar, ipar,
                               *_pack_prims(scene),
                               meta=_meta(scene, cfg, interpret), w=cam.w,
                               n_pix=n_pix, interpret=interpret)
    img = jnp.stack([r[:n_pix], g[:n_pix], b[:n_pix]], axis=-1)
    return img.reshape(cam.h, cam.w, 3)
