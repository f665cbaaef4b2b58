"""Vec3 component-plane math (utils/vec3.py)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_jax.utils.vec3 import Vec3, vmax, vmin

from helpers import vec3_of


def _np(v):
    return np.asarray(v.to_array())


def test_roundtrip_and_arithmetic(rng):
    a = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    va, vb = vec3_of(a), vec3_of(b)

    np.testing.assert_allclose(_np(va + vb), a + b, rtol=1e-6)
    np.testing.assert_allclose(_np(va - vb), a - b, rtol=1e-6)
    np.testing.assert_allclose(_np(va * vb), a * b, rtol=1e-6)
    np.testing.assert_allclose(_np(va * 2.5), a * 2.5, rtol=1e-6)
    np.testing.assert_allclose(_np(-va), -a, rtol=1e-6)


def test_geometry(rng):
    a = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    va, vb = vec3_of(a), vec3_of(b)

    np.testing.assert_allclose(
        np.asarray(va.dot(vb)), (a * b).sum(-1), rtol=1e-5
    )
    np.testing.assert_allclose(_np(va.cross(vb)), np.cross(a, b), rtol=1e-5)
    n = _np(va.normalized())
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)

    # reflection preserves length and flips the normal component
    nrm = vec3_of(np.tile([0.0, 0.0, 1.0], (32, 1)))
    r = _np(va.reflect(nrm))
    np.testing.assert_allclose(r[:, 2], -a[:, 2], rtol=1e-5)
    np.testing.assert_allclose(r[:, :2], a[:, :2], rtol=1e-5)


def test_where_gather_minmax(rng):
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    va, vb = vec3_of(a), vec3_of(b)
    mask = jnp.asarray(rng.random(16) > 0.5)
    got = _np(Vec3.where(mask, va, vb))
    np.testing.assert_array_equal(got, np.where(np.asarray(mask)[:, None], a, b))

    idx = jnp.asarray(rng.integers(0, 16, 8))
    np.testing.assert_array_equal(_np(va.gather(idx)), a[np.asarray(idx)])

    np.testing.assert_array_equal(_np(vmin(va, vb)), np.minimum(a, b))
    np.testing.assert_array_equal(_np(vmax(va, vb)), np.maximum(a, b))


def test_is_pytree():
    v = Vec3.splat((1.0, 2.0, 3.0), (4,))
    leaves = jax.tree.leaves(v)
    assert len(leaves) == 3
    doubled = jax.jit(lambda x: x * 2.0)(v)
    np.testing.assert_allclose(_np(doubled)[:, 1], 4.0)
