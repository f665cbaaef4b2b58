"""Sphere primitive through the full scene path (SURVEY §2.8c: capability
present in the reference API even though its driver never populates it)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_jax.models.scene import Spheres
from raytracing_jax.ops import traverse
from raytracing_jax.render import integrator

from helpers import quad_mesh, simple_scene, vec3_of


def _scene_with_sphere():
    spheres = Spheres.make([[0.0, 0.0, 1.5]], [0.5], [0])
    return simple_scene(quad_mesh(), bg=(0.3, 0.3, 0.3), spheres=spheres)


def test_sphere_closer_than_triangle_wins():
    scene = _scene_with_sphere()
    o = vec3_of([[0.0, 0.0, 3.0]])
    d = vec3_of([[0.0, 0.0, -1.0]])
    hit = traverse.intersect_scene(scene, o, d, method="brute")
    # sphere surface at z=2 -> t=1; quad behind at t=3
    assert np.isclose(float(hit["t"][0]), 1.0, atol=1e-5)
    assert int(hit["sph"][0]) == 0
    assert int(hit["tri"][0]) == -1


def test_triangle_wins_when_ray_misses_sphere():
    scene = _scene_with_sphere()
    o = vec3_of([[0.9, 0.9, 3.0]])
    d = vec3_of([[0.0, 0.0, -1.0]])
    hit = traverse.intersect_scene(scene, o, d, method="brute")
    assert np.isclose(float(hit["t"][0]), 3.0, atol=1e-4)
    assert int(hit["sph"][0]) == -1
    assert int(hit["tri"][0]) >= 0


def test_sphere_shading_normal():
    scene = _scene_with_sphere()
    o = vec3_of([[0.0, 0.0, 3.0]])
    d = vec3_of([[0.0, 0.0, -1.0]])
    uni = jax.random.uniform(jax.random.PRNGKey(0), (2, 4, 1))

    from raytracing_jax.models.scene import SHADER_DEBUG_NORMAL

    scene = scene.replace(
        materials=scene.materials.replace(
            shader_kind=jnp.asarray([SHADER_DEBUG_NORMAL], jnp.int32)
        ).with_rows()
    )
    rad, _ = integrator.trace(
        scene, o, d, uni, 2, method="brute"
    )
    # front of the sphere: normal (0,0,1) -> color (0.5, 0.5, 1.0)
    np.testing.assert_allclose(
        np.asarray(rad.to_array())[0], [0.5, 0.5, 1.0], atol=1e-4
    )


def test_stack_kernel_with_sphere_override():
    """intersect_scene(method='stack') hands sphere winners to the sphere
    pass exactly as 'brute' does: same t, same sphere/triangle ids."""
    scene = _scene_with_sphere()
    R = 256
    rng = np.random.default_rng(11)
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = 3.0
    d = rng.normal(0, 0.25, (R, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov, dv = vec3_of(o), vec3_of(d)
    a = traverse.intersect_scene(scene, ov, dv, method="stack",
                                 interpret=True)
    b = traverse.intersect_scene(scene, ov, dv, method="brute")
    sph = np.asarray(b["sph"])
    assert (sph >= 0).any() and (np.asarray(b["tri"]) >= 0).any()
    for k in ("sph", "tri"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]),
                               rtol=1e-6)
