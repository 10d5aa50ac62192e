"""Frozen dataclass pytrees.

``@dataclass`` makes a frozen dataclass and registers it with
``jax.tree_util.register_dataclass``: fields declared with
``field(pytree_node=False)`` are static (part of the treedef, hashed into jit
cache keys); every other field is a leaf. Instances get ``.replace(**kw)``.
"""
from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a static marker (``pytree_node=False``)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
