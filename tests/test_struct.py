"""The in-repo pytree dataclass (``slam_constructor_tpu.struct``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_constructor_tpu import struct


@struct.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array = None
    scale: float = struct.field(pytree_node=False, default=0.1)


def test_tree_round_trip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)), scale=0.5)
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2  # static field is not a leaf
    q = jax.tree.unflatten(treedef, leaves)
    assert isinstance(q, _Pair) and q.scale == 0.5
    np.testing.assert_array_equal(np.asarray(q.a), np.arange(3.0))
    doubled = jax.tree.map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(np.asarray(doubled.b), 2 * np.ones((2, 2)))
    # a None leaf is an empty subtree, as for any pytree
    assert len(jax.tree.leaves(_Pair(a=jnp.zeros(1)))) == 1


def test_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2))
    q = p.replace(a=jnp.ones(2), scale=0.2)
    assert q.scale == 0.2 and p.scale == 0.1
    np.testing.assert_array_equal(np.asarray(p.a), np.zeros(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_static_field_is_part_of_the_treedef():
    f = jax.jit(lambda p: p.a * p.scale)
    np.testing.assert_allclose(np.asarray(f(_Pair(a=jnp.ones(2), scale=0.5))), 0.5)
    np.testing.assert_allclose(np.asarray(f(_Pair(a=jnp.ones(2), scale=2.0))), 2.0)
    t1 = jax.tree.structure(_Pair(a=jnp.ones(2), scale=0.5))
    t2 = jax.tree.structure(_Pair(a=jnp.ones(2), scale=2.0))
    assert t1 != t2


def test_engine_state_is_a_pytree():
    """The engine states built on the module flatten, jit and replace."""
    from slam_constructor_tpu.ops import cells, grid

    gm = grid.make_grid_map(cells.BayesAvgCell(), 8, 8, 0.1)
    out = jax.jit(lambda g: g.replace(cells=g.cells + 1.0))(gm)
    assert out.scale == 0.1
    np.testing.assert_array_equal(np.asarray(out.cells), np.asarray(gm.cells) + 1.0)
