"""Dense top-k traversal vs the exact paths (DFS + brute force oracle)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_jax.ops import intersect, traverse

from helpers import random_mesh, random_rays, simple_scene, vec3_of


def _cmp_t(a, b):
    return (
        np.where(np.isfinite(a), a, 1e30),
        np.where(np.isfinite(b), b, 1e30),
    )


@pytest.mark.parametrize("n", [50, 300, 1500, 5000])
def test_verified_topk_exact(n, rng):
    """The verified dense traversal must agree with the brute-force oracle
    on EVERY ray — the escalation path guarantees exactness."""
    mesh = random_mesh(n, rng)
    scene = simple_scene(mesh)
    origin, direction = random_rays(512, rng)
    o, d = vec3_of(origin), vec3_of(direction)

    brute = intersect.intersect_bruteforce(o, d, scene.triangles)
    ver = traverse.intersect_bvh_verified(o, d, scene.triangles, scene.bvh)

    got, want = _cmp_t(np.asarray(ver["t"]), np.asarray(brute["t"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fast_topk_close_to_oracle(rng):
    """Unverified single-pass traversal: small truncation error allowed on
    adversarial incoherent rays (the verified path fixes the residual)."""
    mesh = random_mesh(1500, rng)
    scene = simple_scene(mesh)
    origin, direction = random_rays(512, rng)
    o, d = vec3_of(origin), vec3_of(direction)

    brute = intersect.intersect_bruteforce(o, d, scene.triangles)
    # perf-tuned defaults (k=4) trade a little single-pass accuracy for
    # speed; wider settings recover it, and the verified path is exact
    fast = traverse.intersect_bvh_topk(o, d, scene.triangles, scene.bvh)
    got, want = _cmp_t(np.asarray(fast["t"]), np.asarray(brute["t"]))
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() > 0.95
    wide = traverse.intersect_bvh_topk(
        o, d, scene.triangles, scene.bvh, k=8, k_leaf=16
    )
    got, want = _cmp_t(np.asarray(wide["t"]), np.asarray(brute["t"]))
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() > 0.99


def test_topk_camera_rays_on_structured_scene(rng):
    """Coherent camera-like rays must be exact even unverified."""
    mesh = random_mesh(2000, rng)
    scene = simple_scene(mesh)
    g = np.linspace(-0.4, 0.4, 16)
    gx, gy = np.meshgrid(g, g)
    dirs = np.stack([gx, gy, np.full_like(gx, -1.0)], axis=-1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.tile([[0.0, 0.0, 3.0]], (len(dirs), 1)).astype(np.float32)

    o, d = vec3_of(origin), vec3_of(dirs.astype(np.float32))
    brute = intersect.intersect_bruteforce(o, d, scene.triangles)
    ver = traverse.intersect_bvh_verified(o, d, scene.triangles, scene.bvh)
    got, want = _cmp_t(np.asarray(ver["t"]), np.asarray(brute["t"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_chunked_bruteforce_matches_dense(rng):
    mesh = random_mesh(700, rng)
    scene = simple_scene(mesh)
    origin, direction = random_rays(128, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    dense = intersect.intersect_bruteforce(o, d, scene.triangles)
    chunked = traverse.intersect_bruteforce_chunked(
        o, d, scene.triangles, chunk=256
    )
    got, want = _cmp_t(np.asarray(chunked["t"]), np.asarray(dense["t"]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_topk_inactive_rays(rng):
    mesh = random_mesh(100, rng)
    scene = simple_scene(mesh)
    origin, direction = random_rays(64, rng)
    hit = traverse.intersect_bvh_verified(
        vec3_of(origin), vec3_of(direction),
        scene.triangles, scene.bvh, active=jnp.zeros((64,), bool),
    )
    assert not np.isfinite(np.asarray(hit["t"])).any()


def test_topk_depth1_scene(rng):
    # tiny scene: single-level tree, candidates skip the internal loop
    mesh = random_mesh(10, rng)
    scene = simple_scene(mesh)
    origin, direction = random_rays(128, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    brute = intersect.intersect_bruteforce(o, d, scene.triangles)
    ver = traverse.intersect_bvh_verified(o, d, scene.triangles, scene.bvh)
    got, want = _cmp_t(np.asarray(ver["t"]), np.asarray(brute["t"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
