"""Frozen dataclass pytrees (utils/pytree): leaves, static fields, .replace."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from raytracer_js_tpu.utils import pytree


@pytree.dataclass
class _Rec:
    x: jnp.ndarray
    y: jnp.ndarray
    n: int = pytree.field(pytree_node=False, default=3)


def test_leaves_and_static_fields():
    r = _Rec(jnp.ones(2), jnp.zeros(3), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2                 # n is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n == 5 and back.x.shape == (2,)
    doubled = jax.tree_util.tree_map(lambda a: a * 2, r)
    assert doubled.n == 5 and float(doubled.x[0]) == 2.0


def test_static_field_keys_the_jit_cache():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.n)
        return r.x * r.n

    assert float(f(_Rec(jnp.ones(2), jnp.ones(2), n=2))[0]) == 2.0
    assert float(f(_Rec(jnp.ones(2) * 3, jnp.ones(2), n=2))[0]) == 6.0
    assert float(f(_Rec(jnp.ones(2), jnp.ones(2), n=7))[0]) == 7.0
    assert traces == [2, 7]                 # new static value -> retrace


def test_replace_and_frozen():
    r = _Rec(jnp.ones(2), jnp.zeros(2))
    r2 = r.replace(n=9, y=jnp.ones(2))
    assert r2.n == 9 and r.n == 3 and float(r2.y[0]) == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.n = 4


def test_field_keeps_dataclass_options():
    f = {f.name: f for f in dataclasses.fields(_Rec)}
    assert f["n"].metadata["pytree_node"] is False
    assert f["x"].metadata == {}            # plain annotation: a leaf
    assert f["n"].default == 3
