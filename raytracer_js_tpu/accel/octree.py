"""Flat Morton-coded octree acceleration structure.

Re-design of the reference's pointer-based dynamic octree
(/root/reference/src/octree.ts, octree_space.ts, octree_entity.ts): instead
of heap nodes with parent pointers, the build quantizes every primitive AABB
to its *covering node* — the deepest axis-aligned cube cell that fully
contains it (the invariant ``add_entity_to_octree`` establishes,
octree_entity.ts:60-79/174-188) — keyed by ``(level, morton(cell))`` and
sorted (SURVEY.md §7 "sorted Morton-coded nodes").

For traversal the sorted nodes are split at ``l_cut``:

* **coarse set** (level <= l_cut): the few large/straddling entities every
  ray tests brute-force (the ground plane, scene walls — exactly the
  entities the reference stores near the root);
* **fine grid** (level > l_cut): entities scattered into a CSR
  ``cell -> entity ids`` table over the 2^L-per-axis finest grid, covering
  every finest cell their AABB overlaps. Rays march this grid with a
  branchless 3-axis DDA (:func:`nearest_hit_octree`) — the data-parallel
  re-expression of the reference's ``OctreeWalker.next()`` state machine
  (octree_space.ts:316-361): same near-to-far cell enumeration, no parent
  pointers, no per-ray control flow, fixed-shape state advanced under one
  ``lax.while_loop``.

The build is host-side NumPy (scene construction is host-side already,
models/scene.SceneBuilder); the result is a frozen pytree. The structure is
*discrete*: traversal results feed through ``stop_gradient`` exactly like the
brute backend's argmin (ops/trace), so staleness under parameter optimization
only affects which primitive is found, not gradient flow; rebuild per scene
edit (rebuild > mutate, SURVEY.md §2 #12).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from ..config import OctreeConfig
from ..models.scene import Scene

Array = jnp.ndarray


@pytree.dataclass
class OctreeAccel:
    # root cube (covers every primitive AABB)
    root_lo: Array          # [3] f32
    root_size: Array        # [] f32
    # coarse: global prim ids at level <= l_cut, padded with -1
    coarse_ids: Array       # [Nc] i32
    # fine grid CSR at resolution R = 2^max_depth
    cell_offsets: Array     # [R^3 + 1] i32
    cell_ids: Array         # [K] i32
    #: chebyshev distance from each cell to the nearest OCCUPIED cell
    #: (0 for occupied), capped at 255 — the empty-space skip field
    #: ("proximity clouds"): the DDA jumps k-1 rings through proven-empty
    #: space instead of marching cell by cell (a sky-grazing ray at R=256
    #: otherwise forces ~700 full-width while_loop steps on every batch)
    skip_dist: Array        # [R^3] u8
    max_depth: int = pytree.field(pytree_node=False, default=4)
    l_cut: int = pytree.field(pytree_node=False, default=1)
    max_per_cell: int = pytree.field(pytree_node=False, default=8)

    @property
    def res(self) -> int:
        return 1 << self.max_depth


# ---------------------------------------------------------------------------
# Build (host-side NumPy)
# ---------------------------------------------------------------------------

def _morton3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
             bits: int) -> np.ndarray:
    """Interleave three ``bits``-bit coordinates into a Morton code
    (the sort key that makes spatially-adjacent nodes adjacent in memory —
    the flat replacement for the reference's ``(z<<2)|(y<<1)|x`` octant code,
    octree_space.ts:45-49, applied across all levels at once)."""
    out = np.zeros_like(ix, dtype=np.int64)
    for b in range(bits):
        out |= ((ix >> b) & 1).astype(np.int64) << (3 * b)
        out |= ((iy >> b) & 1).astype(np.int64) << (3 * b + 1)
        out |= ((iz >> b) & 1).astype(np.int64) << (3 * b + 2)
    return out


def covering_levels(lo: np.ndarray, hi: np.ndarray, root_lo: np.ndarray,
                    root_size: float, max_depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-AABB covering node -> (level [P], cell [P,3] at that level).

    The deepest level whose aligned cell fully contains the AABB — the
    insertion invariant of ``get_covering_node_for_entity``
    (octree_entity.ts:60-79): straddlers live high in the tree. Evaluated
    densely for all levels 0..max_depth and reduced (no per-entity loop).
    """
    P = lo.shape[0]
    levels = np.arange(max_depth + 1)
    cell_sz = root_size / (1 << levels)                       # [L+1]
    rel_lo = (lo - root_lo)[:, None, :]                       # [P, 1, 3]
    rel_hi = (hi - root_lo)[:, None, :]
    cell = np.floor(rel_lo / cell_sz[None, :, None]).astype(np.int64)
    cell = np.clip(cell, 0, (1 << levels)[None, :, None] - 1)
    fits = np.all(rel_hi <= (cell + 1) * cell_sz[None, :, None] + 1e-7
                  * root_size, axis=-1)                       # [P, L+1]
    fits[:, 0] = True                                         # root always fits
    level = np.max(np.where(fits, levels[None, :], -1), axis=1)
    chosen = cell[np.arange(P), level]                        # [P, 3]
    return level.astype(np.int64), chosen


def build_octree(scene: Scene, cfg: OctreeConfig | None = None,
                 l_cut: int | None = None,
                 like: "OctreeAccel | None" = None) -> OctreeAccel:
    """Build the flat octree over a scene's primitive AABBs.

    ``like`` pins the output to a previous accel's array shapes (CSR id
    capacity, coarse capacity, per-cell bound) so an optimization loop can
    rebuild the accel as geometry leaves move WITHOUT changing jit cache
    keys (the staleness policy of optim/fit: rebuild every
    ``FitConfig.accel_every`` steps; raises if the new build exceeds the
    pinned capacity — grow by rebuilding without ``like``). The reference
    instead *mutates* nodes as entities move (entity.ts:50-56,
    octree_entity.ts:92-171); rebuild-over-mutate is the static-shape
    equivalent (SURVEY.md §2 #12).
    """
    from ..models.scene import prim_aabbs

    cfg = cfg or OctreeConfig()
    lo, hi = (np.asarray(a, np.float64) for a in prim_aabbs(scene))
    P = lo.shape[0]
    L = int(cfg.max_depth)
    R = 1 << L
    if l_cut is None:
        l_cut = max(0, min(1, L - 1))

    if P == 0:
        return OctreeAccel(
            root_lo=jnp.zeros(3, jnp.float32), root_size=jnp.ones((), jnp.float32),
            coarse_ids=jnp.full((1,), -1, jnp.int32),
            cell_offsets=jnp.zeros((R ** 3 + 1,), jnp.int32),
            cell_ids=jnp.zeros((0,), jnp.int32),
            skip_dist=jnp.full((R ** 3,), 255, jnp.uint8),
            max_depth=L, l_cut=l_cut, max_per_cell=1)

    # Root cube: cubic with a small margin (the reference instead re-roots
    # outward on demand, octree_entity.ts:125-171; with a static build we
    # size the root up front — same capability, no mutation). Sizing over
    # ALL AABBs degenerates when one huge entity (a ground plane) inflates
    # the root until every small entity shares a handful of cells — so the
    # root covers only the *small-entity population* (extent <= 8x median);
    # oversized or out-of-root entities are forced onto the coarse
    # brute-tested list below, which is where huge straddlers belong anyway.
    extent = (hi - lo).max(axis=1)
    med = np.median(extent)
    small = extent <= 8.0 * med + 1e-12
    if not small.any():
        small = np.ones_like(small)
    scene_lo = lo[small].min(axis=0)
    scene_hi = hi[small].max(axis=0)
    size = float((scene_hi - scene_lo).max()) * (1.0 + 1e-4) + 1e-6
    root_lo = scene_lo - 0.5 * (size - (scene_hi - scene_lo))

    level, cell = covering_levels(lo, hi, root_lo, size, L)
    inside = np.all(lo >= root_lo - 1e-6 * size, axis=1) & np.all(
        hi <= root_lo + size * (1 + 1e-6), axis=1)
    level = np.where(small & inside, level, 0)   # outliers -> coarse (root)

    # Split: the fine-grid scatter is *overlap*-based, so a small entity that
    # merely straddles a high-level split plane (covering level <= l_cut)
    # still lives happily in the grid — unlike the reference, where a
    # straddler is stuck at the root and every ray tests it
    # (octree_entity.test.ts:61-63). Coarse is reserved for entities that
    # would bloat the CSR: huge extent, outside the root, or overlapping
    # more than ``cell_cap`` finest cells.
    cell_sz = size / R
    c_lo = np.clip(np.floor((lo - root_lo) / cell_sz), 0, R - 1).astype(int)
    c_hi = np.clip(np.floor((hi - root_lo) / cell_sz - 1e-9), 0, R - 1).astype(int)
    n_cells = np.prod(c_hi - c_lo + 1, axis=1)
    cell_cap = 64
    fine_mask = small & inside & (n_cells <= cell_cap)
    coarse = np.where(~fine_mask)[0].astype(np.int32)
    if coarse.size == 0:
        coarse = np.full((1,), -1, np.int32)

    # fine grid: scatter every remaining prim into ALL finest cells its AABB
    # overlaps (conservative overlap expansion of its covering node). The
    # scatter is the scene-build hot loop at 1M prims — native scenekit
    # (native/scenekit.cpp sk_fill_csr) when built, NumPy otherwise; both
    # produce identical CSR.
    from .. import native

    offsets, cell_ids, max_per_cell = native.grid_csr(
        lo.astype(np.float32), hi.astype(np.float32), fine_mask,
        np.asarray(root_lo, np.float32), size, L)
    max_per_cell = max(1, max_per_cell)
    if max_per_cell > scene.n_prims:
        raise ValueError("octree cell overflow")      # TreeGrowError analogue

    if like is not None:
        if (cell_ids.size > like.cell_ids.shape[0]
                or coarse.size > like.coarse_ids.shape[0]
                or max_per_cell > like.max_per_cell
                or L != like.max_depth):
            raise ValueError(
                "octree rebuild exceeds pinned capacity "
                f"(ids {cell_ids.size}>{like.cell_ids.shape[0]} or coarse "
                f"{coarse.size}>{like.coarse_ids.shape[0]} or per-cell "
                f"{max_per_cell}>{like.max_per_cell}); rebuild without "
                "like= and re-jit")
        cell_ids = np.concatenate(
            [cell_ids, np.zeros(like.cell_ids.shape[0] - cell_ids.size,
                                cell_ids.dtype)])     # never indexed
        coarse = np.concatenate(
            [coarse, np.full(like.coarse_ids.shape[0] - coarse.size, -1,
                             coarse.dtype)])
        max_per_cell = like.max_per_cell

    # empty-space skip field: chebyshev distance to the nearest occupied
    # cell (scipy chamfer transform of the empty mask when available),
    # capped at u8. The numpy fallback iteratively box-dilates the
    # occupancy mask and caps the distance low — an UNDERestimate only
    # weakens the walker's skip stride, never correctness (the skip field
    # promises "no occupied cell within d", and a smaller d promises less).
    occ = (np.diff(offsets) > 0).reshape(R, R, R)
    if not occ.any():
        dist = np.full((R, R, R), 255, np.int64)
    else:
        try:
            from scipy import ndimage

            dist = ndimage.distance_transform_cdt(~occ, metric="chessboard")
        except ImportError:
            dist = _chebyshev_dist_np(occ, cap=15)
    skip = np.minimum(dist, 255).astype(np.uint8).reshape(-1)

    return OctreeAccel(
        root_lo=jnp.asarray(root_lo, jnp.float32),
        root_size=jnp.asarray(size, jnp.float32),
        coarse_ids=jnp.asarray(coarse),
        cell_offsets=jnp.asarray(offsets, jnp.int32),
        cell_ids=jnp.asarray(cell_ids),
        skip_dist=jnp.asarray(skip),
        max_depth=L, l_cut=l_cut, max_per_cell=max(1, max_per_cell))


def _chebyshev_dist_np(occ: "np.ndarray", cap: int = 15) -> "np.ndarray":
    """Chebyshev distance to the nearest occupied cell, numpy-only.

    One radius-1 box dilation per iteration (three separable axis passes of
    shifted maxima); cells not reached after ``cap`` steps report ``cap``
    (an underestimate of the true distance — conservative for the walker's
    empty-space skip). Dependency-free fallback for
    ``scipy.ndimage.distance_transform_cdt`` (pyproject declares only
    jax+numpy).
    """
    cur = occ.copy()
    dist = np.where(occ, 0, cap).astype(np.int16)
    for d in range(1, cap):
        for ax in range(3):
            fwd = np.roll(cur, 1, axis=ax)
            bwd = np.roll(cur, -1, axis=ax)
            # zero the wrapped slab (roll is circular; the grid edge is not)
            sl = [slice(None)] * 3
            sl[ax] = 0
            fwd[tuple(sl)] = False
            sl[ax] = -1
            bwd[tuple(sl)] = False
            cur = cur | fwd | bwd
        newly = cur & (dist == cap)
        if not newly.any():
            break
        dist[newly] = d
    return dist.astype(np.int64)


def build_node_directory(scene: Scene, cfg: OctreeConfig | None = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (level, Morton) covering-node directory -> (levels, mortons).

    Host-side build product for inspection and the reference-walker parity
    API (:func:`walk_nodes`). Deliberately NOT part of :class:`OctreeAccel`:
    traversal never reads it, and dead structure in the hot-path pytree is
    cost without capability (it used to ride every jit invocation).
    """
    from ..models.scene import prim_aabbs

    cfg = cfg or OctreeConfig()
    lo, hi = (np.asarray(a, np.float64) for a in prim_aabbs(scene))
    if lo.shape[0] == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    L = int(cfg.max_depth)
    accel = build_octree(scene, cfg)
    root_lo = np.asarray(accel.root_lo, np.float64)
    size = float(accel.root_size)
    level, cell = covering_levels(lo, hi, root_lo, size, L)
    inside = np.all(lo >= root_lo - 1e-6 * size, axis=1) & np.all(
        hi <= root_lo + size * (1 + 1e-6), axis=1)
    extent = (hi - lo).max(axis=1)
    med = np.median(extent)
    small = extent <= 8.0 * med + 1e-12
    if not small.any():
        small = np.ones_like(small)
    level = np.where(small & inside, level, 0)
    key = (level << (3 * L)) | _morton3(cell[:, 0], cell[:, 1], cell[:, 2], L)
    node_key = np.unique(key)
    return ((node_key >> (3 * L)).astype(np.int32),
            (node_key & ((1 << (3 * L)) - 1)).astype(np.int32))


# ---------------------------------------------------------------------------
# Generic per-(ray, candidate) primitive test
# ---------------------------------------------------------------------------

def prim_hit_t(scene: Scene, org: Array, dir: Array, pid: Array) -> Array:
    """First-forward hit param of primitive ``pid`` per lane; inf for pid<0.

    Branchless type dispatch over the global [spheres|boxes|tris] ordering —
    the flat replacement for the reference's virtual ``collision_info``
    (entity.ts:58-60). Shapes: org/dir [..., 3], pid [...] -> t [...].
    """
    from ..ops import intersect as I

    t = jnp.full(pid.shape, jnp.inf, org.dtype)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    pid_c = jnp.clip(pid, 0, max(scene.n_prims - 1, 0))
    if scene.n_spheres:
        i = jnp.clip(pid_c, 0, s_end - 1)
        c, r = scene.sphere_center[i], scene.sphere_radius[i]
        oc = org - c
        b_half = jnp.sum(oc * dir, -1)
        a = jnp.sum(dir * dir, -1)
        cc = jnp.sum(oc * oc, -1) - r ** 2
        disc = b_half ** 2 - a * cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        tn, tf = (-b_half - sq) / a, (-b_half + sq) / a
        ts = jnp.where(tn >= 0, tn, jnp.where(tf >= 0, tf, jnp.inf))
        ts = jnp.where(disc >= 0, ts, jnp.inf)
        t = jnp.where(pid_c < s_end, ts, t)
    if scene.n_boxes:
        i = jnp.clip(pid_c - s_end, 0, scene.n_boxes - 1)
        c, h = scene.box_center[i], scene.box_half[i]
        te, tx, _, _ = I._slab(org, dir, c - h, c + h)
        tb = jnp.where(te >= 0, te, jnp.where(tx >= 0, tx, jnp.inf))
        tb = jnp.where(te <= tx, tb, jnp.inf)
        t = jnp.where((pid_c >= s_end) & (pid_c < b_end), tb, t)
    if scene.n_tris:
        i = jnp.clip(pid_c - b_end, 0, scene.n_tris - 1)
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        e1, e2 = v1 - v0, v2 - v0
        pv = jnp.cross(dir, e2)
        det = jnp.sum(e1 * pv, -1)
        inv = 1.0 / jnp.where(jnp.abs(det) < I.MT_EPS, I.MT_EPS, det)
        sv = org - v0
        u = jnp.sum(sv * pv, -1) * inv
        qv = jnp.cross(sv, e1)
        v = jnp.sum(dir * qv, -1) * inv
        tt = jnp.sum(e2 * qv, -1) * inv
        ok = (jnp.abs(det) >= I.MT_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt >= 0)
        t = jnp.where(pid_c >= b_end, jnp.where(ok, tt, jnp.inf), t)
    return jnp.where(pid >= 0, t, jnp.inf)


def prim_contains(scene: Scene, point: Array, pid: Array) -> Array:
    """Does primitive ``pid`` contain ``point``? Branchless type dispatch
    (the ``is_within`` virtual of entity.ts:73-75: sphere entity_sphere.ts,
    box entity_box.ts; triangles have no interior). pid < 0 -> False.
    Shapes: point [..., 3], pid [...] -> bool [...]."""
    inside = jnp.zeros(pid.shape, bool)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    pid_c = jnp.clip(pid, 0, max(scene.n_prims - 1, 0))
    if scene.n_spheres:
        i = jnp.clip(pid_c, 0, s_end - 1)
        d2 = jnp.sum((point - scene.sphere_center[i]) ** 2, -1)
        inside = jnp.where(pid_c < s_end,
                           d2 <= scene.sphere_radius[i] ** 2, inside)
    if scene.n_boxes:
        i = jnp.clip(pid_c - s_end, 0, scene.n_boxes - 1)
        rel = jnp.abs(point - scene.box_center[i])
        inside = jnp.where((pid_c >= s_end) & (pid_c < b_end),
                           jnp.all(rel <= scene.box_half[i], -1), inside)
    return inside & (pid >= 0)


def point_query_candidates(accel: OctreeAccel, point: Array) -> Array:
    """Candidate prim ids whose AABB may contain ``point`` -> [N, K + Nc].

    The grid-accelerated replacement for testing every primitive: a fine
    entity containing p overlaps p's finest cell (the CSR scatter covers the
    whole AABB), so the cell's CSR span plus the coarse list is a superset
    of all containing entities — the ``entity_at_pos`` contract
    (octree_entity.ts:191-202) without the pointer descent. Padding/absent
    candidates are -1.
    """
    n = point.shape[0]
    R = accel.res
    cell_sz = accel.root_size / R
    rel = (point - accel.root_lo) / cell_sz
    in_root = jnp.all((rel >= 0.0) & (rel < R), axis=-1)
    cell = jnp.clip(rel.astype(jnp.int32), 0, R - 1)
    lin = (cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]
    base = accel.cell_offsets[lin]                              # [N]
    cnt = accel.cell_offsets[lin + 1] - base
    k = jnp.arange(max(accel.max_per_cell, 1), dtype=jnp.int32)[None, :]
    nk = accel.cell_ids.shape[0]
    if nk:
        idx = jnp.clip(base[:, None] + k, 0, nk - 1)
        fine = jnp.where((k < cnt[:, None]) & in_root[:, None],
                         accel.cell_ids[idx], -1)               # [N, K]
    else:
        fine = jnp.full((n, 1), -1, jnp.int32)
    coarse = jnp.broadcast_to(accel.coarse_ids[None, :],
                              (n, accel.coarse_ids.shape[0]))
    return jnp.concatenate([fine, coarse], axis=1)


# ---------------------------------------------------------------------------
# Traversal: wavefront 3-axis DDA (the OctreeWalker re-expression)
# ---------------------------------------------------------------------------

def nearest_hit_octree(scene: Scene, accel: OctreeAccel, org: Array,
                       dir: Array) -> Tuple[Array, Array]:
    """Nearest forward hit via coarse brute + fine-grid DDA -> (t, pid).

    Contract identical to ops/trace.nearest_hit_brute (pid -1 on miss).
    Near-to-far guarantee: the DDA enumerates finest cells in ray order
    (the property the reference walker tests assert,
    test/octree-space-walker.test.ts:22-71); marching stops once the
    per-ray best hit precedes the current cell entry (standard grid
    early-exit), so the first cell containing the true nearest hit
    terminates the lane.
    """
    n = org.shape[0]
    dt = org.dtype
    R = accel.res
    cell_sz = accel.root_size / R

    # --- coarse brute pass ------------------------------------------------
    t_best = jnp.full((n,), jnp.inf, dt)
    pid_best = jnp.full((n,), -1, jnp.int32)
    nc = accel.coarse_ids.shape[0]
    if nc:
        tc = prim_hit_t(scene, org[:, None, :], dir[:, None, :],
                        jnp.broadcast_to(accel.coarse_ids[None, :], (n, nc)))
        j = jnp.argmin(tc, axis=1)
        t0 = jnp.min(tc, axis=1)
        p0 = accel.coarse_ids[j]
        upd = t0 < t_best
        t_best = jnp.where(upd, t0, t_best)
        pid_best = jnp.where(upd & jnp.isfinite(t0), p0, pid_best)

    if accel.cell_ids.shape[0] == 0:
        return t_best, pid_best

    # --- fine-grid DDA with empty-space skipping --------------------------
    # Root slab: entry/exit params of the grid cube.
    inv = 1.0 / jnp.where(jnp.abs(dir) < 1e-12,
                          jnp.where(dir < 0, -1e-12, 1e-12), dir)
    lo = accel.root_lo
    hi = accel.root_lo + accel.root_size
    ta = (lo - org) * inv
    tb = (hi - org) * inv
    t_enter = jnp.max(jnp.minimum(ta, tb), axis=-1)
    t_exit = jnp.min(jnp.maximum(ta, tb), axis=-1)
    t_cur = jnp.maximum(t_enter, 0.0)
    in_grid = t_cur <= t_exit

    step_pos = (dir >= 0).astype(dt)                              # [N, 3]
    #: time to cross one chebyshev ring of cells (max-axis speed)
    dt_cheb = cell_sz / jnp.max(jnp.abs(dir), axis=-1)            # [N]
    eps_t = 1e-4 * dt_cheb

    max_steps = 3 * R + 2

    def cond(state):
        _, _, _, alive, it = state
        return jnp.logical_and(jnp.any(alive), it < max_steps)

    def body(state):
        t_best, pid_best, t_cur, alive, it = state
        # position-based stepping: re-derive the cell from the current
        # param (jumps make incremental per-axis t_next bookkeeping moot)
        p = org + (t_cur + eps_t)[:, None] * dir
        cell = jnp.clip(jnp.floor((p - lo) / cell_sz).astype(jnp.int32),
                        0, R - 1)                                 # [N, 3]
        lin = (cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]
        base = accel.cell_offsets[lin]
        cnt = accel.cell_offsets[lin + 1] - base

        # one BATCHED [n, max_per_cell] candidate test per DDA step — a
        # sequential per-slot fori_loop issued max_per_cell gather rounds
        # per step and was ~10x slower at 1M prims (r3: 49.5 s for a
        # 261k-ray slice; the gathers, not the arithmetic, dominate)
        j = jnp.arange(accel.max_per_cell, dtype=base.dtype)
        idx = jnp.clip(base[:, None] + j[None, :], 0,
                       accel.cell_ids.shape[0] - 1)
        pid = jnp.where((j[None, :] < cnt[:, None]) & alive[:, None],
                        accel.cell_ids[idx], -1)               # [n, K]
        t = prim_hit_t(scene, org[:, None, :], dir[:, None, :], pid)
        jmin = jnp.argmin(t, axis=1)
        t_min = jnp.min(t, axis=1)
        pid_min = jnp.take_along_axis(pid, jmin[:, None], axis=1)[:, 0]
        upd = t_min < t_best
        t_best = jnp.where(upd, t_min, t_best)
        pid_best = jnp.where(upd, pid_min, pid_best)

        # advance: at least to the current cell's exit (the walker step,
        # octree_space.ts:344-352); through empty space, jump k-2 chebyshev
        # rings — the skip field guarantees no occupied cell within k-1
        # rings, and a ray crosses at most floor(tau/dt_cheb)+1 rings in
        # time tau, so tau = (k-2)*dt_cheb stays strictly inside the
        # proven-empty ball (no hit can be skipped: there is nothing there)
        nb = lo + (cell.astype(dt) + step_pos) * cell_sz
        t_exit_cell = jnp.min((nb - org) * inv, axis=-1)
        k = accel.skip_dist[lin].astype(dt)
        t_jump = t_cur + jnp.maximum(k - 2.0, 0.0) * dt_cheb
        t_new = jnp.maximum(jnp.maximum(t_exit_cell, t_jump),
                            t_cur + eps_t)
        done = ((~jnp.isinf(t_best) & (t_best <= t_new))
                | (t_new > t_exit))
        alive_n = alive & ~done
        t_cur_n = jnp.where(alive_n, t_new, t_cur)
        return t_best, pid_best, t_cur_n, alive_n, it + 1

    t_best, pid_best, *_ = jax.lax.while_loop(
        cond, body, (t_best, pid_best, t_cur, in_grid, 0))
    pid_best = jnp.where(jnp.isfinite(t_best), pid_best, -1)
    return t_best, pid_best


def walk_nodes(accel: OctreeAccel, directory, org, dir,
               max_steps: int | None = None):
    """Occupied-node itinerary of one ray, near -> far (host-side, tests).

    ``directory`` is the (levels, mortons) pair from
    :func:`build_node_directory`. Emits ``(level, (cx, cy, cz))`` stops in
    the order the reference walker yields them
    (test/octree-space-walker.test.ts:38-71): when the ray first enters any
    descendant of an occupied node, the node is emitted — ancestors before
    descendants, near before far, each node once.
    """
    import numpy as np

    L = accel.max_depth
    levels, mortons = directory
    keys = {(int(l), int(m)) for l, m in zip(levels, mortons)}
    seen = set()
    out = []
    for cell in walk_cells(accel, org, dir, max_steps):
        for lvl in range(0, L + 1):
            shift = L - lvl
            c = tuple(int(x) >> shift for x in cell)
            m = int(_morton3(np.array([c[0]]), np.array([c[1]]),
                             np.array([c[2]]), L)[0])
            k = (lvl, m)
            if k in keys and k not in seen:
                seen.add(k)
                out.append((lvl, c))
    return out


def octant_code(cell) -> int:
    """Reference octant bit code ``(z << 2) | (y << 1) | x``
    (octree_space.ts:45-49) of a depth-1 cell."""
    x, y, z = cell
    return (int(z) << 2) | (int(y) << 1) | int(x)


def walk_cells(accel: OctreeAccel, org, dir, max_steps: int | None = None):
    """Finest-cell itinerary of one ray, near -> far (host-side, for tests).

    The observable contract of the reference walker
    (test/octree-space-walker.test.ts): cells pierced by the ray in order.
    """
    org = np.asarray(org, np.float64)
    dir = np.asarray(dir, np.float64)
    R = accel.res
    lo = np.asarray(accel.root_lo, np.float64)
    size = float(accel.root_size)
    cell_sz = size / R
    inv = 1.0 / np.where(np.abs(dir) < 1e-12,
                         np.where(dir < 0, -1e-12, 1e-12), dir)
    ta = (lo - org) * inv
    tb = (lo + size - org) * inv
    t_enter = np.max(np.minimum(ta, tb))
    t_exit = np.min(np.maximum(ta, tb))
    t = max(t_enter, 0.0) + 1e-9
    if t > t_exit:
        return []
    cell = np.clip(((org + t * dir - lo) / cell_sz).astype(int), 0, R - 1)
    step = np.where(dir >= 0, 1, -1).astype(int)
    nb = lo + (cell + (step > 0)) * cell_sz
    t_next = (nb - org) * inv
    out = []
    for _ in range(max_steps or (3 * R + 2)):
        out.append(tuple(cell))
        ax = int(np.argmin(t_next))
        if t_next[ax] > t_exit:
            break
        cell = cell.copy()
        cell[ax] += step[ax]
        if cell[ax] < 0 or cell[ax] >= R:
            break
        t_next = t_next.copy()
        t_next[ax] += cell_sz * abs(inv[ax])
    return out
