"""Frozen dataclasses registered as JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are pytree
leaves, except those declared with ``struct.field(pytree_node=False)``,
which are static metadata (part of the treedef, hashed at trace time).
Instances get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that also marks the field as a pytree leaf
    (default) or as static metadata (``pytree_node=False``)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Turn ``cls`` into a frozen dataclass registered with
    ``jax.tree_util.register_dataclass``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )
