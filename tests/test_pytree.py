"""The dataclass-pytree helper (utils/pytree.py)."""

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_jax.utils import pytree


@pytree.dataclass
class Node:
    a: Any
    b: Any
    n: int = pytree.field(pytree_node=False, default=3)


def test_flatten_unflatten_roundtrip():
    x = Node(a=jnp.arange(3.0), b=(jnp.ones(2), None), n=7)
    leaves, tree = jax.tree_util.tree_flatten(x)
    assert len(leaves) == 2  # static n and None are not leaves
    y = jax.tree_util.tree_unflatten(tree, leaves)
    assert y.n == 7
    np.testing.assert_array_equal(y.a, x.a)
    np.testing.assert_array_equal(y.b[0], x.b[0])


def test_replace_returns_new_frozen_instance():
    x = Node(a=1.0, b=2.0)
    y = x.replace(b=5.0, n=9)
    assert (x.b, x.n) == (2.0, 3) and (y.a, y.b, y.n) == (1.0, 5.0, 9)
    with pytest.raises(AttributeError):
        x.a = 4.0


def test_static_fields_are_jit_cache_keys():
    traces = []

    @jax.jit
    def f(x):
        traces.append(x.n)
        return x.a * x.n

    assert float(f(Node(a=jnp.float32(2.0), b=None, n=3))) == 6.0
    assert float(f(Node(a=jnp.float32(4.0), b=None, n=3))) == 12.0
    assert float(f(Node(a=jnp.float32(2.0), b=None, n=5))) == 10.0
    assert traces == [3, 5]  # retraced only when the static field changed


def test_tree_map_keeps_static_fields():
    x = Node(a=jnp.ones(2), b=jnp.zeros(2), n=4)
    y = jax.tree_util.tree_map(lambda v: v + 1, x)
    assert y.n == 4
    np.testing.assert_array_equal(y.b, np.ones(2))
