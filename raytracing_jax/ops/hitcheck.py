"""A traversal against the brute-force oracle, at real widths.

Ray sets drawn from a scene's camera and from its first bounce, the
exhaustive oracle over ray chunks (bounded (N, chunk) planes), and the
mismatch counts under the traversal contract's tolerances. Used by
chip_smoke.py and tools/traverse_ab.py on the device, and by the tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_jax.models.scene import ATTR_NG
from raytracing_jax.ops import intersect
from raytracing_jax.render import camera as camera_mod
from raytracing_jax.utils.vec3 import Vec3


def _vec3(a: np.ndarray) -> Vec3:
    a = np.asarray(a, np.float32)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                jnp.asarray(a[:, 2]))


def _np3(v: Vec3) -> np.ndarray:
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], 1)


def camera_rays(scene, n: int, width: int, height: int, seed: int):
    """n jittered camera rays through uniformly drawn pixels of a
    width x height frame. Returns (origin, direction) Vec3 planes."""
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.integers(0, width, n).astype(np.int32))
    py = jnp.asarray(rng.integers(0, height, n).astype(np.int32))
    ju = jnp.asarray(rng.random(n).astype(np.float32))
    jv = jnp.asarray(rng.random(n).astype(np.float32))
    return camera_mod.generate_rays(scene.camera, width, height, px, py,
                                    ju, jv)


def bounce_rays(scene, origin: Vec3, direction: Vec3, hit, seed: int):
    """First-bounce rays: from each hit, a uniform direction on the
    hemisphere of the geometric normal facing the incoming ray, from an
    origin lifted 1e-3 off the surface. Lanes that missed stay inactive.
    Returns (origin, direction, active)."""
    rng = np.random.default_rng(seed)
    t = np.asarray(hit["t"])
    live = np.isfinite(t)
    o, d = _np3(origin), _np3(direction)
    tri = np.maximum(np.asarray(hit["tri"]), 0)
    ng = np.asarray(scene.triangles.attr_rows)[tri, ATTR_NG:ATTR_NG + 3]
    ng = np.where((ng * d).sum(1, keepdims=True) > 0, -ng, ng)
    p = o + d * np.where(live, t, 0.0)[:, None] + ng * 1e-3
    nd = rng.normal(size=o.shape)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    nd = np.where((nd * ng).sum(1, keepdims=True) < 0, -nd, nd)
    return _vec3(p), _vec3(nd), jnp.asarray(live)


def bruteforce(triangles, origin: Vec3, direction: Vec3, active,
               chunk: int = 2048):
    """intersect_bruteforce over chunks of `chunk` rays (the ray count
    must divide). Returns dict(t, tri, u, v), misses as t=inf, tri=-1."""

    @jax.jit
    def run(o, d, act):
        def one(c):
            return intersect.intersect_bruteforce(
                Vec3(c[0], c[1], c[2]), Vec3(c[3], c[4], c[5]), triangles
            )

        planes = jnp.stack([o.x, o.y, o.z, d.x, d.y, d.z])
        planes = jnp.moveaxis(planes.reshape(6, -1, chunk), 1, 0)
        out = {k: v.reshape(-1) for k, v in jax.lax.map(one, planes).items()}
        out["t"] = jnp.where(act, out["t"], jnp.inf)
        out["tri"] = jnp.where(jnp.isfinite(out["t"]), out["tri"], -1)
        return out

    return run(origin, direction, active)


def uv_tolerance(triangles, origin: np.ndarray, direction: np.ndarray,
                 tri: np.ndarray):
    """Per-hit u/v tolerance: 1e-5 plus 16 f32 ulps of the barycentrics'
    conditioning |o - v0| * max(|e1|, |e2|) / |det|. Moller-Trumbore forms
    u and v as ratios whose numerators cancel, so they lose digits in
    proportion to the ray's distance over the triangle's size and to
    1/|cos| of grazing incidence; two programs that schedule (or fuse the
    multiply-adds of) the same arithmetic differently disagree there."""
    k = np.maximum(tri, 0)
    v0 = _np3(triangles.v0)[k]
    e1 = _np3(triangles.e1)[k]
    e2 = _np3(triangles.e2)[k]
    det = np.abs((e1 * np.cross(direction, e2)).sum(1))
    size = np.maximum(np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1))
    cond = np.linalg.norm(origin - v0, axis=1) * size / np.maximum(det, 1e-30)
    return 1e-5 + 16 * np.finfo(np.float32).eps * cond


def compare(got, want, triangles, origin: Vec3, direction: Vec3) -> dict:
    """Mismatch counts of a traversal `got` against the oracle `want`:

    - tri_mismatch: different triangles, except near-ties (both t within
      1e-6 * max(1, t));
    - t_mismatch: agreeing hits whose t differ by more than 1e-5 relative;
    - uv_mismatch: agreeing hits whose u or v differ by more than
      uv_tolerance (uv_over_1e-5 counts those beyond a flat 1e-5).
    """
    g = {k: np.asarray(v) for k, v in got.items()}
    w = {k: np.asarray(v) for k, v in want.items()}
    gt = np.where(np.isfinite(g["t"]), g["t"], 1e30)
    wt = np.where(np.isfinite(w["t"]), w["t"], 1e30)
    g_tri = np.where(np.isfinite(g["t"]), g["tri"], -1)
    w_tri = np.where(np.isfinite(w["t"]), w["tri"], -1)
    tie = np.abs(gt - wt) <= 1e-6 * np.maximum(1.0, np.abs(wt))
    same = (g_tri == w_tri) & (w_tri >= 0)
    duv = np.maximum(np.abs(g["u"] - w["u"]), np.abs(g["v"] - w["v"]))
    tol = uv_tolerance(triangles, _np3(origin), _np3(direction), w_tri)
    return {
        "rays": int(len(gt)),
        "hits": int((w_tri >= 0).sum()),
        "tri_mismatch": int(((g_tri != w_tri) & ~tie).sum()),
        "near_ties": int(((g_tri != w_tri) & tie).sum()),
        "t_mismatch": int(
            (same & (np.abs(gt - wt) > 1e-5 * np.abs(wt))).sum()
        ),
        "uv_mismatch": int((same & (duv > tol)).sum()),
        "uv_over_1e-5": int((same & (duv > 1e-5)).sum()),
    }
