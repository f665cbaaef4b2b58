"""Integrator semantics (reference cast_ray, raytracer.c:505-558)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_jax.models.scene import SHADER_DEBUG_NORMAL
from raytracing_jax.render import integrator

from helpers import quad_mesh, random_mesh, random_rays, simple_scene, \
    vec3_of

BG = (0.25, 0.5, 0.75)


def _trace(scene, origins, dirs, bounces=4, seed=0, method="brute"):
    r = len(origins)
    uni = jax.random.uniform(jax.random.PRNGKey(seed), (bounces, 4, r))
    rad, rays = integrator.trace(
        scene, vec3_of(origins), vec3_of(dirs), uni, bounces, method=method,
    )
    return np.asarray(rad.to_array()), float(rays)


def test_miss_returns_background():
    scene = simple_scene(quad_mesh(), bg=BG)
    rad, rays = _trace(scene, [[5, 5, 5]], [[0, 0, 1]])
    np.testing.assert_allclose(rad[0], BG, rtol=1e-5)
    assert rays == 1.0  # one primary ray, then inactive


def test_emissive_hit_accumulates_emission():
    scene = simple_scene(quad_mesh(), bg=BG)
    from raytracing_jax.utils.vec3 import Vec3

    scene = scene.replace(
        materials=scene.materials.replace(
            emission=Vec3(
                x=jnp.asarray([1.0]), y=jnp.asarray([2.0]), z=jnp.asarray([3.0])
            )
        ).with_rows()
    )
    rad, _ = _trace(scene, [[0, 0, 3]], [[0, 0, -1]], bounces=1)
    # single bounce: radiance = emission (throughput 1); no background since
    # the bounce budget is exhausted afterwards
    np.testing.assert_allclose(rad[0], [1, 2, 3], rtol=1e-4)


def test_backface_hit_skips_through():
    # ray approaches the quad from behind (normal +z, ray travels +z):
    # dot(ng, dir) > 0 -> skip, re-cast from epsilon-advanced origin,
    # eventually missing to the background (raytracer.c:516-521)
    scene = simple_scene(quad_mesh(), bg=BG)
    rad, rays = _trace(scene, [[0, 0, -3]], [[0, 0, 1]], bounces=4)
    np.testing.assert_allclose(rad[0], BG, rtol=1e-5)
    assert rays == 2.0  # backface recast consumed one extra intersection


def test_backface_exhausts_bounces_returns_emission_only():
    scene = simple_scene(quad_mesh(), bg=BG)
    rad, _ = _trace(scene, [[0, 0, -3]], [[0, 0, 1]], bounces=1)
    np.testing.assert_allclose(rad[0], [0, 0, 0], atol=1e-7)


def test_debug_shader_renders_normals():
    scene = simple_scene(quad_mesh(), bg=BG)
    scene = scene.replace(
        materials=scene.materials.replace(
            shader_kind=jnp.asarray([SHADER_DEBUG_NORMAL], jnp.int32)
        ).with_rows()
    )
    rad, _ = _trace(scene, [[0, 0, 3]], [[0, 0, -1]], bounces=4)
    # quad normal +z -> color (0.5, 0.5, 1.0); terminate stops the path
    np.testing.assert_allclose(rad[0], [0.5, 0.5, 1.0], atol=1e-5)


def test_diffuse_bounce_collects_tinted_background():
    scene = simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0))
    n = 512
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    rad = []
    for s in range(4):
        r, _ = _trace(scene, o, d, bounces=8, seed=s)
        rad.append(r)
    mean = np.concatenate(rad).mean(axis=0)
    # white furnace-ish: grey 0.8 lambertian under uniform white sky; Monte
    # Carlo mean should be near albedo * sky with loose tolerance
    assert 0.5 < mean[0] < 0.95
    # grey material: channels equal
    np.testing.assert_allclose(mean, mean[0], rtol=0.02)


def test_rays_traced_counts_bounces():
    scene = simple_scene(quad_mesh(), bg=BG)
    # most paths continue past the primary hit (a few terminate when the
    # sampled lobe lands below the horizon, pdf <= 0 -> terminate, which is
    # reference behavior, driver.c:309/328)
    n = 64
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    _, rays = _trace(scene, o, d, bounces=8)
    assert rays > 1.5 * n


def test_russian_roulette_unbiased_and_kills_paths():
    """--rr (beyond-parity): from bounce RR_START a continuing path
    survives with p = clip(max(throughput), .05, 1) and is reweighted by
    1/p — kill rate and reweighting checked directly on one bounce_step;
    unbiasedness checked on the estimator mean."""
    scene = simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0))
    n = 2048
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))

    def run(rr, seed):
        uni = jax.random.uniform(jax.random.PRNGKey(seed), (12, 4, n))
        rad, rays = integrator.trace(
            scene, vec3_of(o), vec3_of(d), uni, 12, method="brute", rr=rr,
        )
        return np.asarray(rad.to_array()), float(rays)

    plain = np.concatenate([run(False, s)[0] for s in range(4)])
    rr = np.concatenate([run(True, 100 + s)[0] for s in range(4)])
    # unbiased: means agree within MC noise (grey 0.8 albedo, white sky)
    np.testing.assert_allclose(rr.mean(), plain.mean(), rtol=0.03)

    # direct kill/reweight check: throughput 0.3 -> survive with p=0.3
    tp = 0.3
    st = {
        "origin": vec3_of(o), "direction": vec3_of(d),
        "throughput": integrator.Vec3.full((n,), tp),
        "radiance": integrator.Vec3.zeros((n,)),
        "active": jnp.ones((n,), bool),
        "rays": jnp.float32(0.0),
    }
    rand4 = jax.random.uniform(jax.random.PRNGKey(1), (4, n))
    out = integrator.bounce_step(
        scene, st, rand4, method="brute", rr=True,
        bounce_i=jnp.int32(integrator.RR_START),
    )
    base = integrator.bounce_step(scene, st, rand4, method="brute")
    cont_base = np.asarray(base["active"])
    cont_rr = np.asarray(out["active"])
    assert cont_base.sum() > 100  # the quad keeps many paths alive
    survive_rate = cont_rr.sum() / cont_base.sum()
    p_nom = tp * 0.8  # tint multiplies in before the gamble (~0.8 albedo)
    assert abs(survive_rate - p_nom) < 0.05, (survive_rate, p_nom)
    # survivors reweighted by their OWN 1/p (p = clipped max component)
    surv = cont_rr
    base_tp = np.stack(
        [np.asarray(getattr(base["throughput"], c)) for c in "xyz"]
    )
    p_lane = np.clip(base_tp.max(axis=0), 0.05, 1.0)
    tpx = np.asarray(out["throughput"].x)[surv]
    np.testing.assert_allclose(
        tpx, (base_tp[0] / p_lane)[surv], rtol=1e-5
    )


def test_bucketed_trace_matches_dense_statistically():
    """trace_bucketed permutes lanes (and thus the RNG stream a sample
    consumes) but must agree with trace() in expectation."""
    scene = simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0))
    n = 4096
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    uni = jax.random.uniform(jax.random.PRNGKey(7), (6, 4, n))
    rad_d, rays_d = integrator.trace(
        scene, vec3_of(o), vec3_of(d), uni, 6, method="brute")
    rad_b, rays_b = integrator.trace_bucketed(
        scene, vec3_of(o), vec3_of(d), jax.random.PRNGKey(7), 6,
        method="brute")
    a = np.asarray(rad_d.to_array()).mean()
    b = np.asarray(rad_b.to_array()).mean()
    np.testing.assert_allclose(b, a, rtol=0.03)
    # slot-keyed RNG: different stream than the pre-drawn dense one, so
    # live-sets differ only statistically
    np.testing.assert_allclose(float(rays_b), float(rays_d), rtol=0.05)


def test_nee_env_unbiased():
    """--nee (beyond-parity): env-light NEE with power-heuristic MIS must
    agree with the plain estimator in expectation, and must count its
    shadow rays."""
    scene = simple_scene(quad_mesh(), bg=(1.0, 0.8, 0.6))
    n = 2048
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1))
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))

    def run(nee, seed):
        uni = jax.random.uniform(jax.random.PRNGKey(seed), (6, 4, n))
        nee_uni = jax.random.uniform(
            jax.random.PRNGKey(seed + 999), (6, 2, n))
        rad, rays = integrator.trace(
            scene, vec3_of(o), vec3_of(d), uni, 6, method="brute",
            nee=nee, nee_uniforms=nee_uni if nee else None,
        )
        return np.asarray(rad.to_array()), float(rays)

    plain = np.concatenate([run(False, s)[0] for s in range(6)])
    nee = np.concatenate([run(True, 100 + s)[0] for s in range(6)])
    # unbiased per channel (colored sky catches channel mixups)
    np.testing.assert_allclose(
        nee.mean(axis=0), plain.mean(axis=0), rtol=0.03)
    # NEE pays one shadow ray per shaded vertex
    assert run(True, 0)[1] > run(False, 0)[1]


def test_bucketed_stack_image_equals_topk():
    """trace_bucketed with the stack kernel (interpret mode) renders the
    same image as with the XLA topk traversal: both are exact, and the
    slot-keyed RNG makes the compaction schedule irrelevant."""
    mesh = random_mesh(900, rng_ := np.random.default_rng(3))
    scene = simple_scene(mesh, bg=(0.7, 0.8, 1.0))
    n = 4096
    o_, d_ = random_rays(n, rng_)
    base, rays0 = integrator.trace_bucketed(
        scene, vec3_of(o_), vec3_of(d_), jax.random.PRNGKey(5), 5,
        method="topk")
    got, rays1 = integrator.trace_bucketed(
        scene, vec3_of(o_), vec3_of(d_), jax.random.PRNGKey(5), 5,
        method="stack", interpret=True)
    np.testing.assert_array_equal(
        np.asarray(base.to_array()), np.asarray(got.to_array())
    )
    assert float(rays0) == float(rays1)


def test_nee_bounce_step_stack_matches_topk():
    """One NEE bounce (primary + shadow traversal) with the stack kernel
    equals the topk bounce: the same hits and shadow tests, with hit
    points equal up to the last bits of t (the two traversals schedule
    the same Moller-Trumbore differently)."""
    from raytracing_jax.utils.vec3 import Vec3

    rng_ = np.random.default_rng(8)
    scene = simple_scene(random_mesh(700, rng_), bg=(0.9, 0.8, 0.7))
    r = 1024
    o_, d_ = random_rays(r, rng_)
    st = {
        "origin": vec3_of(o_), "direction": vec3_of(d_),
        "throughput": Vec3.full((r,), 1.0), "radiance": Vec3.zeros((r,)),
        "active": jnp.ones((r,), bool), "rays": jnp.float32(0.0),
        "prev_pdf": jnp.full((r,), jnp.inf),
    }
    u = jax.random.uniform(jax.random.PRNGKey(2), (4, r), jnp.float32)
    u2 = jax.random.uniform(jax.random.PRNGKey(3), (3, r), jnp.float32)
    a = integrator.bounce_step(scene, dict(st), u, method="topk", nee=True,
                               rand2=u2)
    b = integrator.bounce_step(scene, dict(st), u, method="stack", nee=True,
                               rand2=u2, interpret=True)
    for k in ("origin", "direction", "throughput", "radiance"):
        np.testing.assert_allclose(np.asarray(a[k].to_array()),
                                   np.asarray(b[k].to_array()),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a["prev_pdf"]),
                               np.asarray(b["prev_pdf"]), rtol=1e-5)
    for k in ("active", "rays"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert float(a["rays"]) > r  # shadow rays were cast
