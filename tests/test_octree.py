"""Octree acceleration structure tests.

Mirrors the reference's test strategy (SURVEY.md §4): randomized point/cell
property tests, walker itineraries on hand-built scenes, insertion-depth
invariants — plus the golden contract: octree nearest-hit == brute
nearest-hit on random wavefronts.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from raytracer_js_tpu import RenderConfig, render_hdr
from raytracer_js_tpu.accel.octree import (
    OctreeAccel,
    build_octree,
    covering_levels,
    nearest_hit_octree,
    prim_hit_t,
    walk_cells,
)
from raytracer_js_tpu.config import HitBackend, OctreeConfig
from raytracer_js_tpu.ops.trace import nearest_hit_brute

from scenes import config1_camera, config1_cfg, config1_scene


def _random_scene(n=24, seed=3):
    from raytracer_js_tpu import ResponseType, SceneBuilder

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    sky = b.add_solid_texture((0.3, 0.4, 0.6))
    b.set_sky(sky)
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((1.0, 1.0, 1.0))
    for i in range(n):
        c = rng.uniform(-4, 4, 3)
        if i % 3 == 0:
            b.add_box(c, float(rng.uniform(0.2, 1.0)), m, tex)
        elif i % 3 == 1:
            b.add_sphere(c, float(rng.uniform(0.1, 0.8)), m, tex)
        else:
            v = c + rng.uniform(-0.7, 0.7, (3, 3))
            b.add_triangle(v[0], v[1], v[2], m, tex)
    # one big straddler that must land in a coarse level (the ground-box
    # analogue of octree-entity.test.ts:61-63: straddlers stay high)
    b.add_box((0.0, 0.0, -6.0), (18.0, 18.0, 1.0), m, tex)
    return b.build()


def test_covering_level_invariant():
    """Insertion-depth invariant (test/octree-entity.test.ts:52-64):
    a half-size aligned AABB lands at level 1; an off-grid straddler at 0."""
    root_lo = np.zeros(3)
    lo = np.array([[0.0, 0.0, 0.0],    # exactly child 0 at level 1
                   [0.25, 0.25, 0.25]])  # straddles the level-1 split at 0.5
    hi = np.array([[0.5, 0.5, 0.5],
                   [0.75, 0.75, 0.75]])
    level, cell = covering_levels(lo, hi, root_lo, 1.0, 4)
    assert level[0] >= 1 and np.all(cell[0] == 0)
    assert level[1] == 0
    # the half-size one at level exactly 1? It fits level-1 cell (0,0,0)
    # and no deeper (extent = cell size at level 1).
    assert level[0] == 1


def test_covering_level_randomized():
    """Randomized property (style of test/octree-space.test.ts:6-34): the
    chosen cell fully contains the AABB; the cell one level deeper does not."""
    rng = np.random.default_rng(0)
    n = 200
    lo = rng.uniform(0, 0.9, (n, 3))
    hi = lo + rng.uniform(1e-3, 0.1, (n, 3))
    L = 6
    level, cell = covering_levels(lo, hi, np.zeros(3), 1.0, L)
    for i in range(n):
        sz = 1.0 / (1 << level[i])
        assert np.all(lo[i] >= cell[i] * sz - 1e-9)
        assert np.all(hi[i] <= (cell[i] + 1) * sz + 1e-6)
        if level[i] < L:
            sz2 = sz / 2
            c2 = np.floor(lo[i] / sz2)
            assert not np.all(hi[i] <= (c2 + 1) * sz2 + 1e-9), (
                "deeper cell would also fit — level not maximal")


def test_walk_cells_orderings():
    """Walker itineraries (style of test/octree-space-walker.test.ts:22-36):
    axis-aligned and diagonal rays over a depth-1 grid yield exact cell
    sequences; reversal yields the reversed path."""
    scene = _random_scene(4)
    accel = build_octree(scene, OctreeConfig(max_depth=1))
    lo = np.asarray(accel.root_lo)
    size = float(accel.root_size)
    c = lo + 0.25 * size      # center of cell (0,0,0)

    # diagonal: must visit monotonically nondecreasing cells, start 000 end 111
    path = walk_cells(accel, c, np.array([1.0, 1.0, 1.0]) / np.sqrt(3))
    assert path[0] == (0, 0, 0) and path[-1] == (1, 1, 1)
    arr = np.array(path)
    assert np.all(np.diff(arr, axis=0) >= 0) and np.all(np.diff(arr, axis=0).sum(1) == 1)

    # +x ray: exactly two cells
    assert walk_cells(accel, c, np.array([1.0, 0.0, 0.0])) == [(0, 0, 0), (1, 0, 0)]
    # reverse direction from the far corner mirrors the path
    path_rev = walk_cells(accel, lo + 0.75 * size, -np.ones(3) / np.sqrt(3))
    assert path_rev[0] == (1, 1, 1) and path_rev[-1] == (0, 0, 0)


def test_walk_cells_entry_from_outside():
    """A ray starting outside the root enters at the boundary cell
    (walker setup_cur_node contract, octree_space.ts:259-277)."""
    scene = _random_scene(4)
    accel = build_octree(scene, OctreeConfig(max_depth=2))
    lo = np.asarray(accel.root_lo)
    size = float(accel.root_size)
    start = lo + np.array([-1.0, 0.1 * size, 0.1 * size])
    path = walk_cells(accel, start, np.array([1.0, 0.0, 0.0]))
    assert path[0][0] == 0 and len(path) == accel.res


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_octree_nearest_hit_matches_brute(depth):
    scene = _random_scene(30)
    accel = build_octree(scene, OctreeConfig(max_depth=depth))
    rng = np.random.default_rng(depth)
    n = 256
    org = jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    t_b, p_b = nearest_hit_brute(scene, org, d)
    t_o, p_o = nearest_hit_octree(scene, accel, org, d)
    t_b, p_b, t_o, p_o = map(np.asarray, (t_b, p_b, t_o, p_o))
    hit = p_b >= 0
    # t must agree everywhere a hit exists (pid may differ only on exact ties)
    # rtol 1e-4: the traversal evaluates the same tests per candidate in a
    # different program, whose fusion may round differently
    np.testing.assert_allclose(t_o[hit], t_b[hit], rtol=1e-4, atol=1e-6)
    assert np.array_equal(p_o[~hit], p_b[~hit])
    ties = p_o[hit] != p_b[hit]
    assert ties.mean() < 0.02, f"{ties.sum()} pid mismatches beyond tie rate"


def test_render_octree_backend_matches_brute():
    scene = config1_scene(with_glass=True, with_tri=True)
    cam = config1_camera(24, 24)
    cfg_b = config1_cfg()
    cfg_o = config1_cfg(backend=HitBackend.OCTREE)
    accel = build_octree(scene, OctreeConfig(max_depth=3))
    img_b = np.asarray(render_hdr(scene, cam, cfg_b))
    img_o = np.asarray(render_hdr(scene, cam, cfg_o, accel=accel))
    np.testing.assert_allclose(img_o, img_b, rtol=1e-5, atol=1e-6)


def test_substance_point_query_grid_matches_dense():
    """Grid-accelerated substance lookup == dense innermost-containment
    (the entity_at_pos analogue, octree_entity.ts:191-202), including
    nested entities and undefined substances."""
    from raytracer_js_tpu import ResponseType, SceneBuilder
    from raytracer_js_tpu.ops.trace import substance_refr_at

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    glass = b.add_substance(1.5)
    water = b.add_substance(1.333)
    trans = b.add_material(ResponseType.TRANSMISSION)
    tex = b.add_solid_texture((1.0, 1.0, 1.0))
    rng = np.random.default_rng(11)
    for i in range(40):
        c = rng.uniform(-2, 2, 3)
        sub = [glass, water, -1][i % 3]      # incl. undefined substances
        if i % 2:
            b.add_sphere(c, float(rng.uniform(0.2, 0.9)), trans, tex, sub)
        else:
            b.add_box(c, float(rng.uniform(0.3, 1.2)), trans, tex, sub)
    # nested pair: inner sphere inside outer box -> innermost wins
    b.add_box((5.0, 5.0, 5.0), 2.0, trans, tex, water)
    b.add_sphere((5.0, 5.0, 5.0), 0.4, trans, tex, glass)
    scene = b.build()
    accel = build_octree(scene, OctreeConfig(max_depth=4))

    pts = jnp.asarray(np.concatenate([
        rng.uniform(-3, 7, (512, 3)),
        [[5.0, 5.0, 5.0], [5.0, 5.0, 6.5], [100.0, 0.0, 0.0]],
    ]), jnp.float32)
    cur = jnp.full((pts.shape[0],), 1.0, jnp.float32)
    r_d, f_d = substance_refr_at(scene, pts, cur)
    r_g, f_g = substance_refr_at(scene, pts, cur, accel=accel)
    np.testing.assert_allclose(np.asarray(r_g), np.asarray(r_d), atol=0)
    assert np.array_equal(np.asarray(f_g), np.asarray(f_d))


def test_octree_empty_scene():
    from raytracer_js_tpu import SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.5, 0.5, 0.5)))
    scene = b.build()
    accel = build_octree(scene)
    org = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[1.0, 0, 0]], jnp.float32), (4, 1))
    t, pid = nearest_hit_octree(scene, accel, org, d)
    assert np.all(np.asarray(pid) == -1)


def test_walker_reference_octant_itinerary():
    """The reference's canonical one-level itineraries
    (test/octree-space-walker.test.ts:22-36): diagonal ray (0,0,0)+(1,1,1)
    visits octants [0,1,3,7] (x-step first on boundary ties), and the
    reverse ray from the far corner visits [7,6,4,0]."""
    from raytracer_js_tpu import ResponseType, SceneBuilder
    from raytracer_js_tpu.accel.octree import build_octree, octant_code, walk_cells

    # 8 half-size spheres, one per octant of the unit cube, so the root
    # cube is [0,1]^3 and every depth-1 cell is occupied.
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0, 0, 0)))
    m = b.add_material(ResponseType.REFLECTION)
    t = b.add_solid_texture((1, 1, 1))
    for code in range(8):
        c = np.array([(code >> 0) & 1, (code >> 1) & 1, (code >> 2) & 1])
        b.add_sphere(c * 0.5 + 0.25, 0.25, m, t)
    scene = b.build()
    accel = build_octree(scene, OctreeConfig(max_depth=1))

    eps = 1e-5
    d = np.ones(3) / np.sqrt(3)
    start = np.asarray(accel.root_lo) + eps
    path = [octant_code(c) for c in walk_cells(accel, start, d)]
    assert path == [0, 1, 3, 7], path

    far = np.asarray(accel.root_lo) + float(accel.root_size) - eps
    path_rev = [octant_code(c) for c in walk_cells(accel, far, -d)]
    assert path_rev == [7, 6, 4, 0], path_rev


def test_walk_nodes_ancestors_before_children():
    """Interior nodes are emitted before their pierced children, near->far
    (the two-level itinerary property, test/octree-space-walker.test.ts:38-71)."""
    from raytracer_js_tpu import ResponseType, SceneBuilder
    from raytracer_js_tpu.accel.octree import (build_node_directory,
                                               build_octree, walk_nodes)

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0, 0, 0)))
    m = b.add_material(ResponseType.REFLECTION)
    t = b.add_solid_texture((1, 1, 1))
    # a big straddling sphere (level 0) + small deep spheres near two corners
    b.add_sphere((0.5, 0.5, 0.5), 0.3, m, t)          # straddles -> level 0
    b.add_sphere((0.125, 0.125, 0.125), 0.12, m, t)   # level 2 cell (0,0,0)
    b.add_sphere((0.875, 0.875, 0.875), 0.12, m, t)   # level 2 far corner
    scene = b.build()
    accel = build_octree(scene, OctreeConfig(max_depth=2), l_cut=0)

    d = np.ones(3) / np.sqrt(3)
    start = np.asarray(accel.root_lo) + 1e-5
    directory = build_node_directory(scene, OctreeConfig(max_depth=2))
    stops = walk_nodes(accel, directory, start, d)
    assert stops, "no stops emitted"
    levels = {s[0] for s in stops}
    assert 0 in levels and 2 in levels
    # level-0 root node first (ancestor before children)
    assert stops[0][0] == 0
    # near corner's level-2 node precedes the far corner's
    l2 = [s for s in stops if s[0] == 2]
    assert l2[0][1] == (0, 0, 0) and l2[-1][1] == (3, 3, 3), l2
