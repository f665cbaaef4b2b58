"""The stack traversal kernel (ops/traverse_stack.py) in Pallas interpret
mode against the exact oracles: brute force and the ordered DFS."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_jax.models.bvh import build_bvh
from raytracing_jax.models.scene import pack_triangles
from raytracing_jax.ops import hitcheck, intersect, traverse, traverse_stack
from raytracing_jax.render import renderer

from helpers import random_mesh, random_rays, simple_scene, vec3_of


def _stack(o, d, scene, active=None, **kw):
    return traverse_stack.intersect_bvh_stack(
        o, d, scene.triangles, scene.bvh, active, interpret=True, **kw
    )


def _coherent_rays(r, rng):
    """A pinhole fan of r rays from one origin toward the mesh."""
    side = int(np.ceil(np.sqrt(r)))
    g = np.linspace(-0.5, 0.5, side)
    gx, gy = np.meshgrid(g, g)
    d = np.stack([gx.ravel(), gy.ravel(), -np.ones(side * side)], 1)[:r]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([[0.05, -0.02, 3.0]], (r, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _assert_same_hits(got, want, tris, origin, direction):
    """tri equal except on near-ties; t to 1e-5 relative, u/v to
    hitcheck.uv_tolerance on agreeing hits."""
    g = {k: np.asarray(v) for k, v in got.items()}
    w = {k: np.asarray(v) for k, v in want.items()}
    gt = np.where(np.isfinite(g["t"]), g["t"], 1e30)
    wt = np.where(np.isfinite(w["t"]), w["t"], 1e30)
    w_tri = np.where(np.isfinite(w["t"]), w["tri"], -1)
    tie = np.abs(gt - wt) <= 1e-6 * np.maximum(1.0, np.abs(wt))
    assert ((g["tri"] == w_tri) | tie).all()
    np.testing.assert_allclose(gt, wt, rtol=1e-5)
    same = (g["tri"] == w_tri) & (w_tri >= 0)
    tol = hitcheck.uv_tolerance(tris, np.asarray(origin),
                                np.asarray(direction), w_tri)
    for c in ("u", "v"):
        assert (np.abs(g[c] - w[c]) <= tol)[same].all(), c


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("n", [40, 900, 5000])
def test_matches_bruteforce(n, kind, rng):
    scene = simple_scene(random_mesh(n, rng))
    if kind == "coherent":
        origin, direction = _coherent_rays(1024, rng)
    else:
        origin, direction = random_rays(1024, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = _stack(o, d, scene)
    want = intersect.intersect_bruteforce(o, d, scene.triangles)
    assert np.isfinite(np.asarray(got["t"])).sum() > 0
    _assert_same_hits(got, want, scene.triangles, origin, direction)


@pytest.mark.parametrize("n", [300, 2000])
def test_matches_dfs_oracle(n, rng):
    scene = simple_scene(random_mesh(n, rng))
    origin, direction = random_rays(512, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = _stack(o, d, scene)
    want = traverse.intersect_bvh(o, d, scene.triangles, scene.bvh)
    _assert_same_hits(got, want, scene.triangles, origin, direction)


@pytest.mark.parametrize("frac", [0.0, 0.5])
def test_inactive_lanes_miss(frac, rng):
    scene = simple_scene(random_mesh(500, rng))
    origin, direction = _coherent_rays(256, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    active = jnp.asarray(rng.random(256) < frac)
    got = _stack(o, d, scene, active)
    full = _stack(o, d, scene)
    act = np.asarray(active)
    t = np.asarray(got["t"])
    assert not np.isfinite(t[~act]).any()
    assert (np.asarray(got["tri"])[~act] == -1).all()
    np.testing.assert_array_equal(t[act], np.asarray(full["t"])[act])


@pytest.mark.parametrize("r", [1, 31, 33, 1000])
def test_ray_count_not_a_block_multiple(r, rng):
    scene = simple_scene(random_mesh(300, rng))
    origin, direction = _coherent_rays(r, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = _stack(o, d, scene)
    for k in ("t", "tri", "u", "v"):
        assert got[k].shape == (r,)
    want = intersect.intersect_bruteforce(o, d, scene.triangles)
    _assert_same_hits(got, want, scene.triangles, origin, direction)


@pytest.mark.parametrize("block,warps", [(32, 1), (64, 2), (128, 4)])
def test_block_shapes_agree(block, warps, rng):
    scene = simple_scene(random_mesh(900, rng))
    origin, direction = random_rays(300, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = _stack(o, d, scene, block=block, num_warps=warps)
    ref = _stack(o, d, scene)
    for k in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_depth1_tree(rng):
    """<= 64 triangles: the root's children are leaf blocks directly."""
    scene = simple_scene(random_mesh(50, rng))
    assert scene.bvh.depth == 1 and scene.bvh.n_internal == 1
    origin, direction = _coherent_rays(256, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    want = intersect.intersect_bruteforce(o, d, scene.triangles)
    _assert_same_hits(_stack(o, d, scene), want, scene.triangles, origin,
                      direction)


def test_depth5_tree(rng):
    """> 4,096 leaf blocks (depth 5): any depth runs in one kernel."""
    mesh = random_mesh(40_000, rng)
    bvh, slot_map, _ = build_bvh(mesh)
    assert bvh.depth == 5
    tris = pack_triangles(mesh, slot_map)
    assert tris.capacity // 8 > 4096
    origin, direction = random_rays(256, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = traverse_stack.intersect_bvh_stack(o, d, tris, bvh, interpret=True)
    want = intersect.intersect_bruteforce(o, d, tris)
    assert np.isfinite(np.asarray(got["t"])).sum() > 0
    _assert_same_hits(got, want, tris, origin, direction)


def test_miss_only_rays(rng):
    scene = simple_scene(random_mesh(400, rng))
    r = 128
    o = np.tile([[0.0, 0.0, 5.0]], (r, 1)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1  # away from the mesh
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = _stack(vec3_of(o), vec3_of(d), scene)
    assert not np.isfinite(np.asarray(got["t"])).any()
    assert (np.asarray(got["tri"]) == -1).all()


def test_uv_agree_with_bruteforce(rng):
    scene = simple_scene(random_mesh(900, rng))
    origin, direction = _coherent_rays(1024, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    got = _stack(o, d, scene)
    want = intersect.intersect_bruteforce(o, d, scene.triangles)
    hit = np.isfinite(np.asarray(want["t"]))
    assert hit.sum() > 100
    u, v = np.asarray(got["u"])[hit], np.asarray(got["v"])[hit]
    assert ((u >= -1e-4) & (v >= -1e-4) & (u + v <= 1 + 1e-4)).all()
    tol = hitcheck.uv_tolerance(scene.triangles, origin, direction,
                                np.asarray(want["tri"]))[hit]
    assert (np.abs(u - np.asarray(want["u"])[hit]) <= tol).all()
    assert (np.abs(v - np.asarray(want["v"])[hit]) <= tol).all()
    # the DFS oracle gathers triangles per lane like the kernel does:
    # same schedule, same bits
    dfs = traverse.intersect_bvh(o, d, scene.triangles, scene.bvh)
    np.testing.assert_array_equal(np.asarray(got["u"])[hit],
                                  np.asarray(dfs["u"])[hit])


def _max_stack_depth(scene, o, d):
    """Nearest-first DFS in numpy with the kernel's push rule; the deepest
    stack any ray reaches."""
    mins, maxs = scene.bvh.child_boxes_np()
    n_int = scene.bvh.n_internal
    deepest = 0
    for ro, rd in zip(o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / rd
        stack = [0]
        while stack:
            deepest = max(deepest, len(stack))
            e = stack.pop()
            if e >= n_int:
                continue
            with np.errstate(invalid="ignore"):
                t0 = (mins[e] - ro) * inv
                t1 = (maxs[e] - ro) * inv
            near = np.maximum(np.minimum(t0, t1).max(1), 1e-4)
            far = np.maximum(t0, t1).min(1)
            hits = [(near[k], e * 8 + 1 + k) for k in range(8)
                    if near[k] < far[k]]
            stack.extend(c for _, c in sorted(hits, reverse=True))
    return deepest


@pytest.mark.parametrize("n", [8, 60, 500, 3000])
def test_stack_size_bound(n, rng):
    scene = simple_scene(random_mesh(n, rng))
    origin, direction = random_rays(64, rng)
    depth = _max_stack_depth(scene, origin, direction)
    assert depth <= traverse_stack.stack_size(scene.bvh.depth)


def test_intersect_scene_stack_matches_topk(rng):
    scene = simple_scene(random_mesh(700, rng))
    origin, direction = random_rays(512, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    a = traverse.intersect_scene(scene, o, d, method="stack", interpret=True)
    b = traverse.intersect_scene(scene, o, d, method="topk")
    np.testing.assert_array_equal(np.asarray(a["tri"]), np.asarray(b["tri"]))
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]),
                               rtol=1e-6)


# --- method choice ---------------------------------------------------------


def test_auto_picks_kernel_on_gpu(rng):
    scene = simple_scene(random_mesh(300, rng))
    assert renderer.auto_method(scene, "gpu") == "stack"


def test_auto_picks_topk_on_cpu(rng):
    scene = simple_scene(random_mesh(300, rng))
    assert renderer.auto_method(scene, "cpu") == "topk"


@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_auto_picks_brute_for_tiny_scenes(platform, rng):
    scene = simple_scene(random_mesh(20, rng))
    assert scene.triangles.capacity <= 64
    assert renderer.auto_method(scene, platform) == "brute"


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_auto_raises_on_other_platforms(platform, rng):
    scene = simple_scene(random_mesh(300, rng))
    with pytest.raises(ValueError, match=platform):
        renderer.auto_method(scene, platform)


def test_render_auto_on_cpu_is_topk(rng):
    scene = simple_scene(random_mesh(300, rng))
    kw = dict(spp=1, max_bounces=2, seed=4)
    a, _ = renderer.render(scene, 16, 12, **kw)
    b, _ = renderer.render(scene, 16, 12, method="topk", **kw)
    np.testing.assert_array_equal(a, b)


def _lowered_for_gpu(interpret, rng):
    scene = simple_scene(random_mesh(200, rng))
    origin, direction = random_rays(64, rng)
    o, d = vec3_of(origin), vec3_of(direction)
    f = jax.jit(lambda o, d: traverse_stack.intersect_bvh_stack(
        o, d, scene.triangles, scene.bvh, interpret=interpret))
    return f.trace(o, d).lower(lowering_platforms=("cuda",)).as_text()


def test_kernel_lowers_through_triton(rng):
    """Without interpret=True the kernel is a Triton custom call."""
    assert "xla.gpu.triton" in _lowered_for_gpu(False, rng)


def test_interpret_only_when_asked(rng):
    """interpret=True lowers to plain XLA ops: no Triton call."""
    assert "xla.gpu.triton" not in _lowered_for_gpu(True, rng)
