"""Frozen dataclasses that are JAX pytrees.

`@pytree.dataclass` makes a frozen dataclass whose fields are pytree
children, except those declared with `field(pytree_node=False)`, which are
static aux data (hashed into jit cache keys, never traced). Instances get
`.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; pytree_node=False makes it static aux data."""
    return dataclasses.field(
        metadata={"pytree_node": pytree_node}, **kwargs
    )


def dataclass(cls):
    """Register `cls` as a frozen dataclass pytree with `.replace()`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
