"""Lightmap baking.

Capability parity with lightmap_bake (raytracer.c:722-784): for every
triangle, rasterize its UV-space bounding box with a barycentric inside test,
reconstruct world position + normal per texel, shoot cosine-weighted
hemisphere rays through the full path integrator, and write mean irradiance
to the texel.

Split: texel generation (rasterization) is host-side numpy; the
per-texel hemisphere integration is one giant batched trace on device —
texels x samples rays in a single arena instead of the reference's
triple-nested scalar loop.

Deviations (documented): the reference rejection-samples uniform sphere
directions until cos > 0 (raytracer.c:765-773); we draw Gaussian directions
and reflect the below-horizon half — the same uniform-hemisphere
distribution, stateless. The reference also stores raw float irradiance into
u8 pixels (truncating); we keep an f32 lightmap and let callers encode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_jax import EPSILON
from raytracing_jax.render import integrator
from raytracing_jax.utils.vec3 import Vec3


def _rasterize_host(scene, width: int, height: int):
    """UV-space rasterization of every triangle -> texel records.

    Returns (texel_idx (T,), position (T,3), normal (T,3)) numpy arrays.
    Mirrors the bbox + barycentric inside-test of raytracer.c:727-757.
    """
    tris = scene.triangles
    n = scene.n_triangles

    def planes(v):
        return np.stack(
            [np.asarray(v.x)[:n], np.asarray(v.y)[:n], np.asarray(v.z)[:n]],
            axis=-1,
        )

    uv0 = np.stack(
        [np.asarray(tris.uv0u)[:n], np.asarray(tris.uv0v)[:n]], axis=-1
    ) * [width, height]
    uv1 = np.stack(
        [np.asarray(tris.uv1u)[:n], np.asarray(tris.uv1v)[:n]], axis=-1
    ) * [width, height]
    uv2 = np.stack(
        [np.asarray(tris.uv2u)[:n], np.asarray(tris.uv2v)[:n]], axis=-1
    ) * [width, height]
    v0 = planes(tris.v0)
    v1 = v0 + planes(tris.e1)
    v2 = v0 + planes(tris.e2)
    n0 = planes(tris.n0)
    n1 = planes(tris.n1)
    n2 = planes(tris.n2)

    denom = (uv1[:, 1] - uv2[:, 1]) * (uv0[:, 0] - uv2[:, 0]) + (
        uv2[:, 0] - uv1[:, 0]
    ) * (uv0[:, 1] - uv2[:, 1])

    # Fully vectorized bbox rasterization (round 3 — the per-triangle
    # Python loop took minutes at helmet's 15k triangles): decompose every
    # triangle's clamped UV bbox into a flat candidate-texel arena via
    # cumulative offsets, evaluate barycentrics for ALL candidates at once,
    # then keep the inside ones. Candidate order is triangle-major then
    # row-major within the bbox — identical to the loop (and to
    # raytracer.c:727-757), so overlapping triangles overwrite in the same
    # order.
    mnx = np.maximum(np.trunc(np.minimum(np.minimum(uv0[:, 0], uv1[:, 0]),
                                         uv2[:, 0])).astype(np.int64), 0)
    mxx = np.minimum(np.trunc(np.maximum(np.maximum(uv0[:, 0], uv1[:, 0]),
                                         uv2[:, 0])).astype(np.int64),
                     width - 1)
    mny = np.maximum(np.trunc(np.minimum(np.minimum(uv0[:, 1], uv1[:, 1]),
                                         uv2[:, 1])).astype(np.int64), 0)
    mxy = np.minimum(np.trunc(np.maximum(np.maximum(uv0[:, 1], uv1[:, 1]),
                                         uv2[:, 1])).astype(np.int64),
                     height - 1)

    ok = (np.abs(denom) >= 1e-20) & (mxx >= mnx) & (mxy >= mny)
    tri_ids = np.nonzero(ok)[0]
    if len(tri_ids) == 0:
        return (
            np.zeros(0, np.int64),
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
        )

    bw = mxx[tri_ids] - mnx[tri_ids] + 1
    bh = mxy[tri_ids] - mny[tri_ids] + 1
    area = bw * bh
    starts = np.concatenate([[0], np.cumsum(area)])
    total = int(starts[-1])

    t_of = np.repeat(np.arange(len(tri_ids)), area)  # index into tri_ids
    local = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], area)
    gx = mnx[tri_ids][t_of] + local % bw[t_of]
    gy = mny[tri_ids][t_of] + local // bw[t_of]
    tri = tri_ids[t_of]

    px = gx.astype(np.float64)
    py = gy.astype(np.float64)
    dx2 = px - uv2[tri, 0]
    dy2 = py - uv2[tri, 1]
    w0 = ((uv1[tri, 1] - uv2[tri, 1]) * dx2
          + (uv2[tri, 0] - uv1[tri, 0]) * dy2) / denom[tri]
    w1 = ((uv2[tri, 1] - uv0[tri, 1]) * dx2
          + (uv0[tri, 0] - uv2[tri, 0]) * dy2) / denom[tri]
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -EPSILON) & (w1 >= -EPSILON) & (w2 >= -EPSILON)

    tri = tri[inside]
    w0, w1, w2 = w0[inside], w1[inside], w2[inside]
    pos = (v0[tri] * w0[:, None] + v1[tri] * w1[:, None]
           + v2[tri] * w2[:, None])
    nrm = (n0[tri] * w0[:, None] + n1[tri] * w1[:, None]
           + n2[tri] * w2[:, None])
    return (
        (gx[inside] + gy[inside] * width).astype(np.int64),
        pos.astype(np.float32),
        nrm.astype(np.float32),
    )


def bake_lightmap(
    scene,
    width: int,
    height: int,
    samples: int = 16,
    max_bounces: int = 8,
    seed: int = 0,
    batch_texels: int = 16384,
    method: str = "auto",
):
    """Bake an f32 (H, W, 3) irradiance lightmap."""
    if method == "auto":
        method = "topk" if scene.triangles.capacity > 64 else "brute"

    idx, pos, nrm = _rasterize_host(scene, width, height)
    lightmap = np.zeros((height * width, 3), np.float32)
    key = jax.random.PRNGKey(seed)

    for lo in range(0, len(idx), batch_texels):
        hi = min(lo + batch_texels, len(idx))
        t = hi - lo
        k = jax.random.fold_in(key, lo)
        k_dir, k_mat = jax.random.split(k)

        p = pos[lo:hi]
        nn = nrm[lo:hi]
        nn = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-30)

        # uniform hemisphere about the normal, cosine-weighted estimator;
        # all device arrays batch-minor: (3, t*samples)
        g = jax.random.normal(k_dir, (3, t * samples), jnp.float32)
        d = Vec3(g[0], g[1], g[2]).normalized()
        nrm_v = Vec3(
            jnp.asarray(np.repeat(nn[:, 0], samples)),
            jnp.asarray(np.repeat(nn[:, 1], samples)),
            jnp.asarray(np.repeat(nn[:, 2], samples)),
        )
        cos = d.dot(nrm_v)
        d = Vec3.where(cos < 0, -d, d)
        cos = jnp.abs(cos)

        start = p + nn * EPSILON
        origins = Vec3(
            jnp.asarray(np.repeat(start[:, 0], samples)),
            jnp.asarray(np.repeat(start[:, 1], samples)),
            jnp.asarray(np.repeat(start[:, 2], samples)),
        )
        uni = jax.random.uniform(
            k_mat, (max_bounces, 4, t * samples), jnp.float32
        )
        radiance, _ = integrator.trace(
            scene, origins, d, uni, max_bounces, method=method
        )
        rad = radiance * cos
        out = np.stack(
            [
                np.asarray(rad.x).reshape(t, samples).mean(axis=1),
                np.asarray(rad.y).reshape(t, samples).mean(axis=1),
                np.asarray(rad.z).reshape(t, samples).mean(axis=1),
            ],
            axis=-1,
        )
        lightmap[idx[lo:hi]] = out

    return lightmap.reshape(height, width, 3)
