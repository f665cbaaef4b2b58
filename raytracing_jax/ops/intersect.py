"""Ray/primitive intersection kernels — component-plane layout.

Batched re-design of the reference's 8-wide AVX kernels: the SIMD lane
dimension becomes the batch axis, and every 3-vector is a `Vec3` of separate
x/y/z planes so the minor array dimension is always the batch (see
utils/vec3.py).

Semantics (epsilon tolerances, miss encoding as +inf, no backface cull)
follow the reference exactly:
- Moller-Trumbore triangles: ray_triangles_hit_8, raytracer.c:84-188
- AABB slab test:            ray_aabbs_hit_8,     raytracer.c:190-230
- analytic spheres:          ray_spheres_hit_8,   raytracer.c:34-82
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracing_jax import EPSILON
from raytracing_jax.utils.vec3 import Vec3, vmax, vmin

# python literal (not a jnp scalar): these kernels are shared with the
# Pallas traversal (ops/traverse_stack.py), and Pallas kernel bodies may not
# capture traced constants
INF = float("inf")


def moller_trumbore(origin: Vec3, direction: Vec3, v0: Vec3, e1: Vec3,
                    e2: Vec3, eps: float = EPSILON):
    """Batched Moller-Trumbore (reference raytracer.c:84-157).

    All operands are Vec3 with broadcast-compatible component shapes.
    Returns (t, u, v); t == +inf encodes a miss. Tolerances match the
    reference: barycentrics within +/-eps, t >= eps, no backface culling.
    NaNs from degenerate (all-zero padding) triangles resolve to misses
    through the ordered comparisons.
    """
    pvec = direction.cross(e2)
    det = e1.dot(pvec)
    inv_det = 1.0 / det

    tvec = origin - v0
    qvec = tvec.cross(e1)

    u = inv_det * tvec.dot(pvec)
    v = inv_det * direction.dot(qvec)
    t = inv_det * e2.dot(qvec)

    ok = (
        (u >= -eps)
        & (u <= 1.0 + eps)
        & (v >= -eps)
        & (u + v <= 1.0 + eps)
        & (t >= eps)
    )
    t = jnp.where(ok, t, INF)
    return t, u, v


def aabb_slab(origin: Vec3, inv_dir: Vec3, box_min: Vec3, box_max: Vec3,
              t_min, t_max):
    """Batched slab test (reference raytracer.c:190-230).

    box_min/box_max components broadcast against origin/inv_dir components.
    Returns entry distances with +inf for misses; degenerate zero boxes and
    NaN lanes (origin exactly on a degenerate slab) never hit thanks to the
    ordered `<` compare.
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_small = vmin(t0, t1).max_comp()
    t_big = vmax(t0, t1).min_comp()

    t_near = jnp.maximum(t_small, t_min)
    t_far = jnp.minimum(t_big, t_max)
    return jnp.where(t_near < t_far, t_near, INF)


def sphere_hit(origin: Vec3, direction: Vec3, center: Vec3, radius,
               eps: float = EPSILON):
    """Batched analytic sphere intersection (reference raytracer.c:34-82).

    Only the near root -b - sqrt(d) is taken (rays starting inside a sphere
    miss it), d <= 0 counts as a miss, t <= eps rejected.
    """
    oc = origin - center
    a = direction.dot(direction)
    b = 2.0 * oc.dot(direction)
    c = oc.dot(oc) - radius * radius

    d = b * b - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(d, 0.0))
    t = (-b - sqrt_d) / (2.0 * a)
    ok = (d > 0.0) & (t > eps)
    return jnp.where(ok, t, INF)


def intersect_bruteforce(origin: Vec3, direction: Vec3, triangles,
                         eps: float = EPSILON):
    """Exhaustive intersection of each ray against every triangle — the
    reference's own `#if 0` BVH-correctness oracle (raytracer.c:497-503).

    origin/direction: Vec3 of (R,). Returns dict(t, tri, u, v) of (R,)
    arrays. Candidate axis leads, rays stay minor: intermediates are (N, R).
    """
    o = origin.map(lambda a: a[None, :])  # (1, R)
    d = direction.map(lambda a: a[None, :])
    v0 = triangles.v0.map(lambda a: a[:, None])  # (N, 1)
    e1 = triangles.e1.map(lambda a: a[:, None])
    e2 = triangles.e2.map(lambda a: a[:, None])

    t, u, v = moller_trumbore(o, d, v0, e1, e2, eps)  # (N, R)
    best = jnp.argmin(t, axis=0)  # (R,)
    r = jnp.arange(t.shape[1])
    return {
        "t": t[best, r],
        "tri": best.astype(jnp.int32),
        "u": u[best, r],
        "v": v[best, r],
    }


def intersect_spheres(origin: Vec3, direction: Vec3, spheres, best_t,
                      eps: float = EPSILON):
    """Brute-force sphere pass (reference loops 8-wide blocks,
    raytracer.c:485-489). Returns (t, sphere_index) with t=+inf if none
    beats best_t."""
    s = spheres.count
    r = origin.shape[0]
    if s == 0:
        return jnp.full((r,), INF), jnp.full((r,), -1, jnp.int32)
    o = origin.map(lambda a: a[None, :])
    d = direction.map(lambda a: a[None, :])
    c = spheres.center.map(lambda a: a[:, None])
    t = sphere_hit(o, d, c, spheres.radius[:, None], eps)  # (S, R)
    idx = jnp.argmin(t, axis=0)
    rr = jnp.arange(r)
    tb = t[idx, rr]
    hit = tb < best_t
    return jnp.where(hit, tb, INF), jnp.where(hit, idx.astype(jnp.int32), -1)
