"""Env-light importance sampling (alias table over the equirect map) —
BEYOND PARITY: the sampler's distribution must match its
tables, its pdf must make the estimator exactly unbiased, and the NEE/MIS
integrator with an equirect background must agree with the plain
estimator in expectation.
"""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_jax.io.materials import AtlasBuilder
from raytracing_jax.models.scene import (
    BG_EQUIRECT, Background, Camera, MaterialTable, build_scene,
)
from raytracing_jax.ops import env_light as el
from raytracing_jax.render import integrator
from raytracing_jax.utils import color

from helpers import quad_mesh, vec3_of


def _env_img(rng, h=16, w=32):
    """Dim sky with a bright 'sun' block — strong luminance contrast."""
    img = rng.integers(5, 30, (h, w, 3), dtype=np.int64)
    img[4:7, 10:14] = 255
    return img.astype(np.uint8)


def _atlas_with_env(rng):
    b = AtlasBuilder()
    tid = b.add(_env_img(rng))
    return b.build(), tid


def test_alias_sampler_matches_distribution(rng):
    atlas, tid = _atlas_with_env(rng)
    env = el.build_env_light(atlas, tid)
    n = env.w * env.h

    r = 1 << 18
    u = jax.random.uniform(jax.random.PRNGKey(0), (3, r))
    d, pdf = el.sample(env, u[0], u[1], u[2])
    # eval_pdf at the sampled direction must reproduce the sampler's pdf —
    # except where the float u<->x roundtrip lands a jitter~0/1 sample in
    # the NEIGHBOR texel (a measure-zero boundary set; the sampler's own
    # pdf is the true density there, see ops/env_light.py)
    p_direct = np.asarray(el.eval_pdf(env, d))
    off = ~np.isclose(p_direct, np.asarray(pdf), rtol=1e-4)
    assert off.mean() < 1e-3, f"pdf mismatch on {off.mean():.4%} of samples"

    # histogram of texel picks ~ the stored discrete distribution
    uu = 0.5 + np.arctan2(np.asarray(d.z), np.asarray(d.x)) / (2 * np.pi)
    vv = 0.5 - np.arcsin(np.clip(np.asarray(d.y), -1, 1)) / np.pi
    x = np.clip((uu * env.w).astype(np.int64), 0, env.w - 1)
    y = np.clip((vv * env.h).astype(np.int64), 0, env.h - 1)
    counts = np.bincount(y * env.w + x, minlength=n) / r
    p = np.asarray(env.lum_p).reshape(-1)[:n]
    big = p > 1e-3  # texels with enough mass for a tight frequency check
    np.testing.assert_allclose(counts[big], p[big], rtol=0.05)


def test_sampler_pdf_unbiased_integral(rng):
    """E[f(dir)/pdf(dir)] must equal the true integral of f over the
    sphere — checked against direct quadrature of the luminance map."""
    atlas, tid = _atlas_with_env(rng)
    env = el.build_env_light(atlas, tid)

    r = 1 << 18
    u = jax.random.uniform(jax.random.PRNGKey(1), (3, r))
    d, pdf = el.sample(env, u[0], u[1], u[2])

    # f = linear luminance of the env map at dir (what NEE integrates)
    img = _env_img(rng if False else np.random.default_rng(0), 16, 32)
    # rebuild deterministically: reuse the atlas texels instead
    h, w = env.h, env.w
    off = int(np.asarray(atlas.offset)[tid])
    lin = lambda c: color.srgb_to_linear(  # noqa: E731
        np.asarray(c)[off : off + w * h].astype(np.float32) / 255.0
    )
    lum_map = (
        0.2126 * lin(atlas.tex_r)
        + 0.7152 * lin(atlas.tex_g)
        + 0.0722 * lin(atlas.tex_b)
    ).reshape(h, w)

    uu = 0.5 + np.arctan2(np.asarray(d.z), np.asarray(d.x)) / (2 * np.pi)
    vv = 0.5 - np.arcsin(np.clip(np.asarray(d.y), -1, 1)) / np.pi
    x = np.clip((uu * w).astype(np.int64), 0, w - 1)
    y = np.clip((vv * h).astype(np.int64), 0, h - 1)
    f = lum_map[y, x]
    est = (f / np.asarray(pdf)).mean()

    # direct quadrature: sum f * dOmega over texels
    theta = np.pi * (np.arange(h) + 0.5) / h
    d_omega = (2 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
    want = (lum_map * d_omega).sum()
    np.testing.assert_allclose(est, want, rtol=0.01)


def test_nee_with_env_cdf_unbiased(rng):
    """Full integrator: equirect background + env-CDF NEE must agree with
    the plain estimator in expectation (per channel)."""
    atlas, tid = _atlas_with_env(rng)
    scene = build_scene(
        quad_mesh(),
        materials=MaterialTable.default(1),
        atlas=atlas,
        background=Background(
            kind=BG_EQUIRECT, color=jnp.zeros((3,)), tex_id=tid
        ),
        camera=Camera.default(),
    )
    assert scene.env_light is not None

    n = 2048
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))

    def run(nee, seed):
        uni = jax.random.uniform(jax.random.PRNGKey(seed), (6, 4, n))
        nee_uni = jax.random.uniform(
            jax.random.PRNGKey(seed + 999), (6, 3, n))
        rad, rays = integrator.trace(
            scene, vec3_of(o), vec3_of(d), uni, 6, method="brute",
            nee=nee, nee_uniforms=nee_uni if nee else None,
        )
        return np.asarray(rad.to_array())

    plain = np.concatenate([run(False, s) for s in range(8)])
    nee = np.concatenate([run(True, 100 + s) for s in range(8)])
    np.testing.assert_allclose(
        nee.mean(axis=0), plain.mean(axis=0), rtol=0.05)

    # and the variance should not be WORSE with importance sampling
    assert nee.std(axis=0).mean() <= plain.std(axis=0).mean() * 1.5
