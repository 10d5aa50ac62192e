"""Material table.

Re-design of the reference's virtual Material hierarchy
(/root/reference/src/material.ts:29-103, materials/material_solid.ts): the
abstract methods ``response_type`` / ``is_mirror`` / ``is_light_source`` /
``roughness_index`` become integer/float *columns* indexed by material id, so
the shading step dispatches with branchless mask selects instead of vtables.

``alter_ray`` (material_solid.ts:30-36) — color *= texture(uv) — lives in the
trace step (:mod:`raytracer_js_tpu.ops.trace`), where the color-modulation
product is exactly what inverse-rendering gradients flow through.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import pytree

from ..config import ResponseType

Array = jnp.ndarray


@pytree.dataclass
class MaterialTable:
    response: Array   # [M] i32: ResponseType
    light: Array      # [M] bool: is_light_source (material.ts:51-53)
    mirror: Array     # [M] bool: is_mirror (material.ts:44-46)
    roughness: Array  # [M] f32 in [0, 1] (material.ts:62-64)


# The reference's four canned materials (materials/material_solid.ts:39-44),
# as (response, light, mirror, roughness) rows:
SIMPLE_SMOOTH = (ResponseType.REFLECTION, False, True, 0.0)
SIMPLE_LIGHT = (ResponseType.REFLECTION, True, False, 0.0)
SIMPLE_ROUGH = (ResponseType.REFLECTION, False, True, 0.5)
SIMPLE_TRANSPARENT = (ResponseType.TRANSMISSION, False, False, 0.0)


def make_material_table(rows) -> MaterialTable:
    """Build from a list of (response, light, mirror, roughness) tuples."""
    rows = list(rows)
    if not rows:
        rows = [SIMPLE_SMOOTH]
    return MaterialTable(
        response=jnp.array([int(r[0]) for r in rows], jnp.int32),
        light=jnp.array([bool(r[1]) for r in rows], jnp.bool_),
        mirror=jnp.array([bool(r[2]) for r in rows], jnp.bool_),
        roughness=jnp.array([float(r[3]) for r in rows], jnp.float32),
    )
