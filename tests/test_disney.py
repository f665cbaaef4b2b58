"""Disney BRDF ubershader tests (reference driver.c:118-418)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_jax.ops import disney
from raytracing_jax.utils.vec3 import Vec3

from helpers import vec3_of


def test_cosine_hemisphere_distribution():
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (2, 4096))
    d = disney.sample_cosine_hemisphere(u[0], u[1])
    arr = np.asarray(d.to_array())
    np.testing.assert_allclose(np.linalg.norm(arr, axis=-1), 1.0, atol=1e-4)
    assert (arr[:, 2] >= 0).all()
    # cosine-weighted: E[cos] = 2/3
    assert np.isclose(arr[:, 2].mean(), 2.0 / 3.0, atol=0.02)


def test_vndf_half_vectors_upper_hemisphere():
    key = jax.random.PRNGKey(1)
    u = jax.random.uniform(key, (2, 1024))
    v = np.array([0.3, -0.2, 0.93])
    v = v / np.linalg.norm(v)
    vv = vec3_of(np.tile(v, (1024, 1)))
    ax = jnp.full((1024,), 0.25)
    m = disney.sample_ggx_vndf(vv, ax, ax, u[0], u[1])
    arr = np.asarray(m.to_array())
    np.testing.assert_allclose(np.linalg.norm(arr, axis=-1), 1.0, atol=1e-4)
    assert (arr[:, 2] >= 0).all()
    # visible-normal sampling: dot(V, m) >= 0
    assert (arr @ v >= -1e-5).all()


def _sample(base=(0.8, 0.8, 0.8), rough=0.5, metal=0.0, sheen=0.0,
            sheen_tint=0.0, aniso=0.0, in_z=0.8, n=512, seed=3):
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (3, n))
    in_dir = vec3_of(
        np.tile([np.sqrt(max(1 - in_z**2, 0)), 0.0, in_z], (n, 1))
    )
    f = jnp.full
    out, rgb, pdf = disney.sample_disney_brdf(
        Vec3.splat(base, (n,)),
        f((n,), rough), f((n,), metal), f((n,), sheen),
        f((n,), sheen_tint), f((n,), aniso * aniso),
        in_dir, u[0], u[1], u[2],
    )
    return (
        np.asarray(out.to_array()),
        np.asarray(rgb.to_array()),
        np.asarray(pdf),
    )


def test_diffuse_tint_bounded_by_albedo():
    out, rgb, pdf = _sample(rough=1.0, metal=0.0)
    ok = pdf > 0
    tint = rgb[ok] / pdf[ok][:, None]
    assert np.isfinite(tint).all()
    assert (tint >= 0).all()
    # energy sanity: a rough dielectric can't amplify much beyond albedo
    assert tint.mean() < 1.2


def test_smooth_metal_mirrors():
    out, rgb, pdf = _sample(rough=0.001, metal=1.0, in_z=0.7)
    ok = pdf > 0
    in_dir = np.array([np.sqrt(1 - 0.49), 0.0, 0.7])
    expect = np.array([-in_dir[0], 0.0, in_dir[2]])
    err = np.linalg.norm(out[ok] - expect, axis=-1)
    assert np.median(err) < 0.02
    tint = rgb[ok] / pdf[ok][:, None]
    assert np.isfinite(tint).all()


def test_below_horizon_terminates():
    # viewing from below the surface -> pdf 0 -> terminate
    out, rgb, pdf = _sample(in_z=-0.5)
    assert (pdf <= 0).all()


def test_sheen_adds_energy_at_grazing():
    _, rgb0, pdf0 = _sample(rough=1.0, sheen=0.0, in_z=0.15, seed=9)
    _, rgb1, pdf1 = _sample(rough=1.0, sheen=1.0, in_z=0.15, seed=9)
    ok = (pdf0 > 0) & (pdf1 > 0)
    assert rgb1[ok].sum() > rgb0[ok].sum()


def test_normal_map_identity_when_absent():
    n = vec3_of([[0.0, 0.0, 1.0]])
    t = vec3_of([[1.0, 0.0, 0.0]])
    b = vec3_of([[0.0, 1.0, 0.0]])
    tex = vec3_of([[0.1, 0.9, 0.8]])
    out = disney.apply_normal_map(
        n, t, b, tex, jnp.asarray([1.0]), jnp.asarray([False])
    )
    np.testing.assert_allclose(np.asarray(out.to_array()), [[0, 0, 1]])


def test_normal_map_flat_texture_is_identity():
    # (0.5, 0.5, 1.0) encodes "no perturbation" (with green flip symmetric)
    n = vec3_of([[0.0, 0.0, 1.0]])
    t = vec3_of([[1.0, 0.0, 0.0]])
    b = vec3_of([[0.0, 1.0, 0.0]])
    tex = vec3_of([[0.5, 0.5, 1.0]])
    out = disney.apply_normal_map(
        n, t, b, tex, jnp.asarray([1.0]), jnp.asarray([True])
    )
    np.testing.assert_allclose(
        np.asarray(out.to_array()), [[0, 0, 1]], atol=1e-6
    )


def test_material_fetch_onehot_matches_gather_fallback():
    """shade()'s one-hot material fetch (tables <= 256 rows) must agree
    bit-for-bit with the large-table row-gather fallback on identical
    materials — guards the fallback boundary of the one-hot material
    fetch."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from raytracing_jax.models.scene import MaterialTable, TextureAtlas
    from raytracing_jax.ops import disney
    from raytracing_jax.utils.vec3 import Vec3

    rng = np.random.default_rng(9)
    R = 64

    def scene_with(n_mats):
        mt = MaterialTable.default(n_mats)
        # vary a few parameters so materials are distinguishable
        mt = mt.replace(
            roughness=jnp.asarray(
                rng.uniform(0.05, 1.0, n_mats).astype(np.float32)
            ),
            metalness=jnp.asarray(
                rng.uniform(0.0, 1.0, n_mats).astype(np.float32)
            ),
        )
        mt = mt.replace(rows=MaterialTable.pack_rows(mt)) \
            if hasattr(MaterialTable, "pack_rows") else mt
        class S:  # minimal scene surface for shade()
            materials = mt
            atlas = TextureAtlas.empty()
        return S()

    # rebuild rows if builder helper exists under another name
    small = scene_with(16)
    if small.materials.rows is None:
        import pytest

        pytest.skip("rows builder not exposed; covered by golden tests")
    big_rows = jnp.concatenate(
        [small.materials.rows] * 20, axis=0
    )[:300]  # 300 > 256 -> gather path; rows 0..15 identical to small's
    big = scene_with(16)
    big.materials = big.materials.replace(rows=big_rows)

    n = Vec3.full((R,), 0.0).replace(z=jnp.ones((R,)))
    d = Vec3.full((R,), 0.0).replace(z=-jnp.ones((R,)))
    t = Vec3.full((R,), 0.0).replace(x=jnp.ones((R,)))
    b = Vec3.full((R,), 0.0).replace(y=jnp.ones((R,)))
    mat_id = jnp.asarray(rng.integers(0, 16, R), jnp.int32)
    u = jax.random.uniform(jax.random.PRNGKey(0), (4, R), jnp.float32)
    uvs = jnp.zeros((R,))

    a = disney.shade(small, d, n, n, t, b, uvs, uvs, mat_id, u)
    c = disney.shade(big, d, n, n, t, b, uvs, uvs, mat_id, u)
    for k in ("direction", "tint", "emission"):
        for comp in "xyz":
            np.testing.assert_array_equal(
                np.asarray(getattr(a[k], comp)),
                np.asarray(getattr(c[k], comp)),
            )
    np.testing.assert_array_equal(
        np.asarray(a["terminate"]), np.asarray(c["terminate"])
    )
