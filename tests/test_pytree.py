"""The in-repo pytree dataclass behind Features, PinholeCamera, MapState
and VOState: frozen, .replace, flatten round trip, and transparent to jit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyslam.geometry.camera import PinholeCamera
from tinyslam.types import Features, pytree_dataclass


@pytree_dataclass
class _Pair:
    a: jax.Array
    b: jax.Array


def test_replace_returns_a_copy_and_instances_are_frozen():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(3))
    q = p.replace(b=jnp.full(3, 5.0))
    np.testing.assert_array_equal(np.asarray(p.b), 1.0)
    np.testing.assert_array_equal(np.asarray(q.b), 5.0)
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_flatten_round_trip_keeps_field_order():
    f = Features.empty(4)
    leaves, treedef = jax.tree.flatten(f)
    assert [x.shape for x in leaves] == [(4, 2), (4,), (4,), (4,), (4, 8), (4,)]
    g = jax.tree.unflatten(treedef, leaves)
    assert isinstance(g, Features) and g.capacity == 4
    cam = PinholeCamera.create(500.0, 501.0, 320.0, 240.0)
    assert len(jax.tree.leaves(cam)) == 4


def test_passes_through_jit_vmap_and_tree_map():
    cam = PinholeCamera.create(500.0, 500.0, 320.0, 240.0)

    @jax.jit
    def shift(c: PinholeCamera, f: Features):
        return c.replace(cx=c.cx + 1.0), f.replace(score=f.score + 2.0)

    c2, f2 = shift(cam, Features.empty(3))
    assert float(c2.cx) == 321.0
    np.testing.assert_array_equal(np.asarray(f2.score), 2.0)
    batched = jax.tree.map(lambda x: jnp.stack([x, x]), Features.empty(3))
    counts = jax.vmap(lambda f: f.count)(batched)
    np.testing.assert_array_equal(np.asarray(counts), [0, 0])
