"""Gather-based texture sampling from the flat channel-plane atlas.

Replaces the reference's pointer-based samplers (driver.c:31-93):
texture k lives at texels [offset[k], offset[k]+w*h) in
row-major order across three u8 channel planes; every sample is a flat
gather per channel, batched over the ray arena (results stay (R,)-shaped —
no minor-dim-3 padding).

Wrap semantics match the reference: repeat wrap including the negative-UV
fixup (driver.c:32-37/51-56), bilinear clamps the +1 texel at the image edge
(driver.c:66-67), u8 -> f32 conversion divides by 255.999 (driver.c:43-45).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracing_jax.ops import onehot
from raytracing_jax.utils.vec3 import Vec3


def _wrap01(x):
    """Repeat wrap: the reference's negative fixup + fract collapses to
    x - floor(x) (driver.c:32-38)."""
    return x - jnp.floor(x)


def _tex_params(atlas, tid):
    """Per-ray (width, height, tile_row, tiles_x) for tiled atlases —
    ONE exact one-hot matmul over the (4, K) parameter table instead of
    four per-lane gathers from tiny i32 tables (integers far below 2^24;
    ops/onehot.py holds the precision invariant). Falls back to gathers
    for K > 256 (never in practice)."""
    if atlas.width.shape[0] > 256:
        return (atlas.width[tid], atlas.height[tid],
                atlas.tile_row[tid], atlas.tiles_x[tid])
    table = jnp.stack(
        [atlas.width, atlas.height, atlas.tile_row, atlas.tiles_x]
    ).astype(jnp.float32)  # (4, K)
    got = onehot.fetch_rows_exact(table, tid).astype(jnp.int32)
    return got[0], got[1], got[2], got[3]


def _fetch(atlas, off, w, x, y) -> Vec3:
    """Fetch texel (x, y) -> Vec3 rgb in [0, 1].

    Texels are packed r<<16|g<<8|b in 128-lane u32 pages: the flat texel id
    splits into (page row, lane); one page row gather, then the lane
    extraction is a dense one-hot reduce.
    """
    import jax

    idx = off + y * w + x  # (R,)
    row = idx >> 7
    lane = idx & 127
    page = atlas.pages[row]  # (R, 128) u32 row gather
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1) == lane[:, None]
    )
    packed = jnp.where(one_hot, page, jnp.uint32(0)).sum(
        axis=1, dtype=jnp.uint32
    )
    s = jnp.float32(1.0 / 255.999)
    return Vec3(
        x=((packed >> 16) & 0xFF).astype(jnp.float32) * s,
        y=((packed >> 8) & 0xFF).astype(jnp.float32) * s,
        z=(packed & 0xFF).astype(jnp.float32) * s,
    )


def _tile_page(atlas, trow, tiles_x, x0, y0):
    """Gather the ONE tiled page whose 13x8 tile contains texel (x0, y0),
    plus the in-tile lane of that texel. trow/tiles_x: the texture's
    per-ray tile-table parameters (_tex_params). The page's one-texel
    apron holds the +1 neighbors (pre-clamped at pack time, which IS the
    reference's bilinear edge clamp, driver.c:66-67), so a whole 2x2
    footprint reads from this single 512-byte row."""
    from raytracing_jax.models.scene import TILE_H, TILE_W

    tx = x0 // TILE_W
    ty = y0 // TILE_H
    row = trow + ty * tiles_x + tx
    page = atlas.tpages[row]  # (R, 128) u32 row gather
    lane = (y0 - ty * TILE_H) * (TILE_W + 1) + (x0 - tx * TILE_W)
    return page, lane


def _lane_rgb(page, lane) -> Vec3:
    """Extract lane `lane` of each (128,) page row as Vec3 rgb in [0, 1]:
    dense one-hot reduce, no per-lane gather."""
    import jax

    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1) == lane[:, None]
    )
    packed = jnp.where(one_hot, page, jnp.uint32(0)).sum(
        axis=1, dtype=jnp.uint32
    )
    s = jnp.float32(1.0 / 255.999)
    return Vec3(
        x=((packed >> 16) & 0xFF).astype(jnp.float32) * s,
        y=((packed >> 8) & 0xFF).astype(jnp.float32) * s,
        z=(packed & 0xFF).astype(jnp.float32) * s,
    )


def sample_nearest(atlas, tex_id, uv_u, uv_v) -> Vec3:
    """sample_texture_nearest (driver.c:31-47). tex_id: (R,) i32 (clamped to
    0 for 'no texture' lanes; callers select on tex_id >= 0)."""
    tid = jnp.maximum(tex_id, 0)
    if atlas.tpages is None:  # flat-page fallback (pre-tiling atlases)
        w = atlas.width[tid]
        h = atlas.height[tid]
        u = _wrap01(uv_u)
        v = _wrap01(uv_v)
        x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
        y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
        return _fetch(atlas, atlas.offset[tid], w, x, y)
    w, h, trow, tx = _tex_params(atlas, tid)
    u = _wrap01(uv_u)
    v = _wrap01(uv_v)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    page, lane = _tile_page(atlas, trow, tx, x, y)
    return _lane_rgb(page, lane)


def sample_bilinear(atlas, tex_id, uv_u, uv_v) -> Vec3:
    """sample_texture_bilinear (driver.c:49-93); the pipeline default
    (driver.c:14)."""
    from raytracing_jax.models.scene import TILE_W

    tid = jnp.maximum(tex_id, 0)
    if atlas.tpages is None:  # flat-page fallback (pre-tiling atlases)
        w = atlas.width[tid]
        h = atlas.height[tid]
    else:
        w, h, trow, tx = _tex_params(atlas, tid)

    px = _wrap01(uv_u) * w
    py = _wrap01(uv_v) * h
    x0 = jnp.clip(px.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    a = px - x0
    b = py - y0

    if atlas.tpages is None:
        off = atlas.offset[tid]
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        c00 = _fetch(atlas, off, w, x0, y0)
        c10 = _fetch(atlas, off, w, x1, y0)
        c01 = _fetch(atlas, off, w, x0, y1)
        c11 = _fetch(atlas, off, w, x1, y1)
    else:
        page, lane = _tile_page(atlas, trow, tx, x0, y0)
        c00 = _lane_rgb(page, lane)
        c10 = _lane_rgb(page, lane + 1)
        c01 = _lane_rgb(page, lane + (TILE_W + 1))
        c11 = _lane_rgb(page, lane + (TILE_W + 2))

    c0 = c00.lerp(c10, a)
    c1 = c01.lerp(c11, a)
    return c0.lerp(c1, b)


def sample(atlas, tex_id, uv_u, uv_v, mode: str = "bilinear") -> Vec3:
    if mode == "nearest":
        return sample_nearest(atlas, tex_id, uv_u, uv_v)
    return sample_bilinear(atlas, tex_id, uv_u, uv_v)
