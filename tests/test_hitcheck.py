"""Hit comparison against the oracle (ops/hitcheck.py) and the benchmark's
device busy-time reduction."""

import os
import sys

import numpy as np
import jax.numpy as jnp

from raytracing_jax.ops import hitcheck, intersect

from helpers import random_mesh, simple_scene, vec3_of

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _hits(t, tri, u=None, v=None):
    n = len(t)
    return {
        "t": np.asarray(t, np.float32), "tri": np.asarray(tri, np.int32),
        "u": np.zeros(n, np.float32) if u is None else np.asarray(u),
        "v": np.zeros(n, np.float32) if v is None else np.asarray(v),
    }


def _unit_scene():
    scene = simple_scene(random_mesh(10, np.random.default_rng(0)))
    o = vec3_of(np.tile([[0.0, 0.0, 3.0]], (4, 1)))
    d = vec3_of(np.tile([[0.0, 0.0, -1.0]], (4, 1)))
    return scene, o, d


def test_compare_counts_each_kind_of_mismatch():
    scene, o, d = _unit_scene()
    inf = np.inf
    want = _hits([1.0, 2.0, 3.0, inf], [0, 1, 2, -1], u=[0.1] * 4)
    got = _hits([1.0, 2.5, 3.0, inf], [0, 5, 2, -1],
                u=[0.1, 0.1, 0.6, 0.1])
    c = hitcheck.compare(got, want, scene.triangles, o, d)
    assert (c["rays"], c["hits"]) == (4, 3)
    assert c["tri_mismatch"] == 1 and c["near_ties"] == 0
    assert c["t_mismatch"] == 0 and c["uv_mismatch"] == 1


def test_compare_accepts_near_ties_and_tiny_t_error():
    scene, o, d = _unit_scene()
    want = _hits([2.0, 4.0, np.inf, np.inf], [3, 4, -1, -1])
    got = _hits([2.0 + 1e-6, 4.0 * (1 + 5e-6), np.inf, np.inf],
                [7, 4, -1, -1])
    c = hitcheck.compare(got, want, scene.triangles, o, d)
    assert c["near_ties"] == 1 and c["tri_mismatch"] == 0
    assert c["t_mismatch"] == 0


def test_bruteforce_chunks_match_one_pass(rng):
    scene = simple_scene(random_mesh(300, rng))
    o, d = hitcheck.camera_rays(scene, 512, 64, 48, 3)
    act = jnp.asarray(rng.random(512) < 0.8)
    got = hitcheck.bruteforce(scene.triangles, o, d, act, chunk=128)
    want = intersect.intersect_bruteforce(o, d, scene.triangles)
    t = np.where(np.asarray(act), np.asarray(want["t"]), np.inf)
    # same triangles; t to the last bits (the chunked program fuses the
    # same Moller-Trumbore differently)
    np.testing.assert_allclose(np.asarray(got["t"]), t, rtol=1e-6)
    tri = np.where(np.isfinite(t), np.asarray(want["tri"]), -1)
    np.testing.assert_array_equal(np.asarray(got["tri"]), tri)


def test_bounce_rays_leave_the_surface(rng):
    scene = simple_scene(random_mesh(300, rng))
    o, d = hitcheck.camera_rays(scene, 256, 32, 32, 1)
    hit = intersect.intersect_bruteforce(o, d, scene.triangles)
    bo, bd, live = hitcheck.bounce_rays(scene, o, d, hit, 2)
    live = np.asarray(live)
    assert live.sum() > 0
    assert (live == np.isfinite(np.asarray(hit["t"]))).all()
    np.testing.assert_allclose(np.linalg.norm(hitcheck._np3(bd), axis=1),
                               1.0, rtol=1e-5)


def test_bench_busy_time_is_an_interval_union():
    import bench

    evs = [
        {"ph": "X", "pid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "pid": 1, "ts": 2, "dur": 3},    # nested
        {"ph": "X", "pid": 1, "ts": 8, "dur": 7},    # overlaps the first
        {"ph": "X", "pid": 1, "ts": 30, "dur": 5},   # after a gap
        {"ph": "X", "pid": 2, "ts": 0, "dur": 100},  # a host plane
        {"ph": "M", "pid": 1, "name": "process_name"},
    ]
    assert bench._busy_seconds(evs, {1}) == (15 + 5) / 1e6
