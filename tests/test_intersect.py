"""Unit tests for the intersection kernels (reference raytracer.c:34-230)."""

import numpy as np
import jax.numpy as jnp

from raytracing_jax import EPSILON
from raytracing_jax.ops.intersect import (
    aabb_slab,
    moller_trumbore,
    sphere_hit,
)
from raytracing_jax.utils.vec3 import Vec3

from helpers import vec3_of


def _tri(v0, v1, v2):
    v0 = np.asarray(v0, np.float32)
    return (
        vec3_of([v0]),
        vec3_of([np.asarray(v1, np.float32) - v0]),
        vec3_of([np.asarray(v2, np.float32) - v0]),
    )


def _mt(o, d, v0, e1, e2):
    t, u, v = moller_trumbore(vec3_of([o]), vec3_of([d]), v0, e1, e2)
    return float(t[0]), float(u[0]), float(v[0])


def test_mt_basic_hit():
    v0, e1, e2 = _tri([-1, -1, 0], [1, -1, 0], [0, 1, 0])
    t, u, v = _mt([0, -0.25, -2.0], [0, 0, 1.0], v0, e1, e2)
    assert np.isclose(t, 2.0, atol=1e-5)
    w = 1.0 - u - v
    assert 0 <= u <= 1 and 0 <= v <= 1 and 0 <= w <= 1
    # barycentric reconstruction
    p0 = np.array([-1, -1, 0.0])
    p1 = np.array([1, -1, 0.0])
    p2 = np.array([0, 1, 0.0])
    p = p0 * w + p1 * u + p2 * v
    np.testing.assert_allclose(p, [0.0, -0.25, 0.0], atol=1e-5)


def test_mt_no_backface_cull():
    # the reference has no backface culling (raytracer.c:84-157)
    v0, e1, e2 = _tri([-1, -1, 0], [1, -1, 0], [0, 1, 0])
    t, _, _ = _mt([0, -0.25, 2.0], [0, 0, -1.0], v0, e1, e2)
    assert np.isclose(t, 2.0, atol=1e-5)


def test_mt_miss_and_epsilon():
    v0, e1, e2 = _tri([-1, -1, 0], [1, -1, 0], [0, 1, 0])
    d = [0.0, 0.0, 1.0]
    # clear miss
    t, _, _ = _mt([5.0, 0.0, -2.0], d, v0, e1, e2)
    assert np.isinf(t)
    # t < EPSILON rejected (origin on the plane)
    t, _, _ = _mt([0.0, -0.25, 0.0], d, v0, e1, e2)
    assert np.isinf(t)
    # barycentric tolerance: just outside the edge within eps still hits
    t, _, _ = _mt([0.0, -1.0 - 0.5 * EPSILON, -1.0], d, v0, e1, e2)
    assert np.isfinite(t)


def test_mt_degenerate_padding_triangle_misses():
    z = vec3_of([[0, 0, 0]])
    t, _, _ = moller_trumbore(
        vec3_of([[0, 0, -2.0]]), vec3_of([[0, 0, 1.0]]), z, z, z
    )
    assert np.isinf(float(t[0]))


def test_slab_basic():
    o = vec3_of([[0.0, 0.0, -5.0]])
    inv = vec3_of([[1e30, 1e30, 1.0]])
    box_min = vec3_of([[-1, -1, -1], [3, 3, 3]]).map(lambda a: a[:, None])
    box_max = vec3_of([[1, 1, 1], [4, 4, 4]]).map(lambda a: a[:, None])
    d = aabb_slab(o, inv, box_min, box_max, EPSILON, jnp.inf)  # (2, 1)
    assert np.isclose(float(d[0, 0]), 4.0, atol=1e-4)
    assert np.isinf(float(d[1, 0]))


def test_slab_degenerate_zero_box_misses():
    # zero AABBs (empty BVH lanes) must never hit (SURVEY §3.3)
    o = vec3_of([[5.0, 5.0, 5.0]])
    inv = vec3_of([[-np.sqrt(3)] * 3])
    z = vec3_of([[0, 0, 0]])
    d = aabb_slab(o, inv, z, z, EPSILON, jnp.inf)
    assert np.isinf(float(d[0]))


def test_slab_origin_inside():
    o = vec3_of([[0, 0, 0]])
    inv = vec3_of([[1, 1, 1]])
    d = aabb_slab(
        o, inv, vec3_of([[-1, -1, -1]]), vec3_of([[1, 1, 1]]),
        EPSILON, jnp.inf,
    )
    assert np.isclose(float(d[0]), EPSILON)


def test_slab_respects_tmax_pruning():
    o = vec3_of([[0.0, 0.0, -5.0]])
    inv = vec3_of([[1e30, 1e30, 1.0]])
    d = aabb_slab(
        o, inv, vec3_of([[-1, -1, -1]]), vec3_of([[1, 1, 1]]), EPSILON, 2.0
    )
    assert np.isinf(float(d[0]))  # box at t=4 beyond t_max=2 -> prune


def test_sphere_hit_semantics():
    c = vec3_of([[0.0, 0.0, 0.0]])
    r = jnp.array([1.0])
    d = vec3_of([[0.0, 0.0, 1.0]])
    # outside hit: near root
    t = sphere_hit(vec3_of([[0, 0, -3.0]]), d, c, r)
    assert np.isclose(float(t[0]), 2.0, atol=1e-5)
    # inside the sphere: reference takes only the near root -> miss
    t = sphere_hit(vec3_of([[0, 0, 0.0]]), d, c, r)
    assert np.isinf(float(t[0]))
    # tangent (d == 0) counts as miss
    t = sphere_hit(vec3_of([[1.0, 0, -3.0]]), d, c, r)
    assert np.isinf(float(t[0]))
