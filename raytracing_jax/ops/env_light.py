"""Environment-light importance sampling (luminance CDF over the equirect
map) for NEE/MIS — BEYOND PARITY (the reference has no NEE at all).

Design:
- host build: per-texel linear luminance x sin(theta) row weight ->
  discrete distribution over all texels; an ALIAS TABLE (Vose) makes
  device sampling O(1): ONE uniform picks (slot, accept-fraction), two
  512-byte page-row gathers fetch (prob, alias), a compare picks the
  texel. No per-lane binary search (a two-level CDF searchsorted would
  cost ~22 scalar gathers per lane).
- the sampled texel is jittered uniformly in (u, v) inside its footprint,
  and the pdf is evaluated AT THE SAMPLED POINT: uniform-(u,v) jitter has
  solid-angle density p * w * h / (2 pi^2 sin(theta_point)), so using
  sin(theta) of the actual point (not the row center) keeps the estimator
  exactly unbiased and makes eval_pdf(direction) agree with the sampler's
  own pdf — the MIS power-heuristic weights sum to 1 per direction.
- tables ride the same 128-lane page layout as texels (ops/texture.py):
  gather a row, extract the lane with a dense one-hot reduce.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from raytracing_jax.utils import pytree

from raytracing_jax.utils.vec3 import Vec3

TWO_PI = 2.0 * np.pi
INV_2PISQ = float(1.0 / (2.0 * np.pi * np.pi))


@pytree.dataclass
class EnvLight:
    prob: Any  # (N2, 128) f32 — alias acceptance probability per texel
    alias: Any  # (N2, 128) i32 — alias texel id
    lum_p: Any  # (N2, 128) f32 — discrete texel probability p (sums to 1)
    w: int = pytree.field(pytree_node=False)
    h: int = pytree.field(pytree_node=False)


def build_env_light(atlas, tex_id: int) -> EnvLight | None:
    """Host-side table build from the (u8, sRGB) equirect background
    texture. Returns None for an all-black map (no light to sample)."""
    off = int(np.asarray(atlas.offset)[tex_id])
    w = int(np.asarray(atlas.width)[tex_id])
    h = int(np.asarray(atlas.height)[tex_id])
    sl = slice(off, off + w * h)

    def lin(c):
        # color.srgb_to_linear quirk parity: pure pow decode
        return np.power(np.asarray(c)[sl].astype(np.float64) / 255.0, 2.2)

    lum = (
        0.2126 * lin(atlas.tex_r)
        + 0.7152 * lin(atlas.tex_g)
        + 0.0722 * lin(atlas.tex_b)
    ).reshape(h, w)
    sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    wgt = (lum * sin_t).reshape(-1)
    total = wgt.sum()
    if total <= 0.0:
        return None
    p = wgt / total

    # Vose alias construction (exact, O(N))
    n = w * h
    scaled = p * n
    alias = np.zeros(n, np.int64)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)

    def pages(a, dtype):
        out = np.zeros((max((n + 127) // 128, 1), 128), dtype)
        out.reshape(-1)[:n] = a
        return jnp.asarray(out)

    return EnvLight(
        prob=pages(prob, np.float32),
        alias=pages(alias, np.int32),
        lum_p=pages(p, np.float32),
        w=w, h=h,
    )


def _page_lane(table, idx):
    """table: (N2, 128); idx: (R,) i32 -> (R,) values via one row gather +
    dense one-hot lane extract (the texel-page fast path)."""
    row = idx >> 7
    lane = idx & 127
    page = table[row]  # (R, 128)
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1) == lane[:, None]
    )
    return jnp.where(one_hot, page, jnp.zeros_like(page)).sum(axis=1)


def _dir_from_uv(u, v):
    """Inverse of the equirect mapping (ops/background.py): u = 0.5 +
    atan2(z, x)/2pi, v = 0.5 - asin(y)/pi."""
    phi = (u - 0.5) * TWO_PI
    ang = (0.5 - v) * jnp.pi
    y = jnp.sin(ang)
    r = jnp.cos(ang)  # = sin(theta), the horizontal radius
    return Vec3(x=r * jnp.cos(phi), y=y, z=r * jnp.sin(phi))


def sample(env: EnvLight, u_sel, u_jx, u_jy):
    """Draw one env direction per lane. u_sel picks the alias slot AND its
    accept fraction (the standard one-uniform alias trick); u_jx/u_jy
    jitter inside the texel. Returns (direction Vec3, pdf (R,) in 1/sr)."""
    n = env.w * env.h
    r_ = u_sel * n
    j = jnp.clip(r_.astype(jnp.int32), 0, n - 1)
    frac = r_ - j.astype(jnp.float32)
    pj = _page_lane(env.prob, j)
    aj = _page_lane(env.alias, j).astype(jnp.int32)
    texel = jnp.where(frac < pj, j, aj)

    x = texel % env.w
    y = texel // env.w
    u = (x.astype(jnp.float32) + u_jx) / env.w
    v = (y.astype(jnp.float32) + u_jy) / env.h
    d = _dir_from_uv(u, v)

    p = _page_lane(env.lum_p, texel)
    sin_t = jnp.maximum(jnp.cos((0.5 - v) * jnp.pi), 1e-6)
    pdf = p * (env.w * env.h) * INV_2PISQ / sin_t
    return d, pdf


def eval_pdf(env: EnvLight, d: Vec3):
    """Solid-angle pdf of `sample` at an arbitrary unit direction — the
    light-side term of the BRDF-sample MIS weight at miss time."""
    u = 0.5 + jnp.arctan2(d.z, d.x) * (0.5 / jnp.pi)
    v = 0.5 - jnp.arcsin(jnp.clip(d.y, -1.0, 1.0)) * (1.0 / jnp.pi)
    x = jnp.clip((u * env.w).astype(jnp.int32), 0, env.w - 1)
    y = jnp.clip((v * env.h).astype(jnp.int32), 0, env.h - 1)
    p = _page_lane(env.lum_p, y * env.w + x)
    sin_t = jnp.maximum(jnp.cos((0.5 - v) * jnp.pi), 1e-6)
    return p * (env.w * env.h) * INV_2PISQ / sin_t
