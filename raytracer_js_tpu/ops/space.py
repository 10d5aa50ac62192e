"""Spatial containment predicates.

Re-design of the reference's ``src/space.ts``: the scalar
``point_in_space`` / ``space_in_space`` / ``aabb_in_space`` / overlap-volume
functions (space.ts:55-128) become broadcasting array predicates over
``[..., 3]`` batches — the vectorized primitives the octree build and the
substance point query are expressed with.

``RangeCoverage`` reproduces the reference's open/closed interval modes
(space.ts:40-52): CLOSE_OPEN ``[lo, hi)`` (the octree's cell convention),
OPEN_CLOSE ``(lo, hi]``, and FULL ``[lo, hi]``.
"""
from __future__ import annotations

import enum
from typing import Tuple

import jax.numpy as jnp

Array = jnp.ndarray


class RangeCoverage(enum.IntEnum):
    """Interval endpoint convention (reference space.ts:40-52)."""

    CLOSE_OPEN = 0   # [lo, hi) — octree cells
    OPEN_CLOSE = 1   # (lo, hi]
    FULL = 2         # [lo, hi]


def point_in_space(point: Array, pos: Array, size: Array,
                   coverage: RangeCoverage = RangeCoverage.CLOSE_OPEN) -> Array:
    """Is ``point`` inside the box at ``pos`` with extent ``size``
    (space.ts:55-82)? All args broadcast over leading dims; returns bool[...]."""
    lo = pos
    hi = pos + size
    if coverage == RangeCoverage.CLOSE_OPEN:
        ok = (point >= lo) & (point < hi)
    elif coverage == RangeCoverage.OPEN_CLOSE:
        ok = (point > lo) & (point <= hi)
    else:
        ok = (point >= lo) & (point <= hi)
    return jnp.all(ok, axis=-1)


def space_in_space(inner_pos: Array, inner_size: Array, outer_pos: Array,
                   outer_size: Array) -> Array:
    """Full containment of one box in another (space.ts:85-97)."""
    return jnp.all(
        (inner_pos >= outer_pos)
        & (inner_pos + inner_size <= outer_pos + outer_size), axis=-1)


def aabb_in_space(aabb_pos: Array, aabb_size, outer_pos: Array,
                  outer_size: Array) -> Array:
    """Cubic-AABB containment (space.ts:99-103): ``aabb_size`` is the scalar
    edge length (the reference's AABB record has scalar size)."""
    size3 = jnp.broadcast_to(jnp.asarray(aabb_size)[..., None],
                             aabb_pos.shape)
    return space_in_space(aabb_pos, size3, outer_pos, outer_size)


def get_overlap_space(pos_a: Array, size_a: Array, pos_b: Array,
                      size_b: Array) -> Tuple[Array, Array, Array]:
    """Intersection box of two boxes -> (pos, size, nonempty)
    (space.ts:106-120). ``size`` is clamped at 0 where disjoint."""
    lo = jnp.maximum(pos_a, pos_b)
    hi = jnp.minimum(pos_a + size_a, pos_b + size_b)
    size = jnp.maximum(hi - lo, 0.0)
    nonempty = jnp.all(size > 0.0, axis=-1)
    return lo, size, nonempty


def aabb_overlap_volume(pos_a: Array, size_a: Array, pos_b: Array,
                        size_b: Array) -> Array:
    """Overlap volume (space.ts:122-128); 0 where disjoint."""
    _, size, _ = get_overlap_space(pos_a, size_a, pos_b, size_b)
    return jnp.prod(size, axis=-1)
