"""Color management tests (reference common.h:82-92, raytracer.c:560-572)."""

import numpy as np
import jax.numpy as jnp

from raytracing_jax.utils import color


def test_srgb_to_linear_is_reference_pow_curve():
    # the reference uses a pure pow curve with NO linear segment
    x = np.linspace(0, 1, 64, dtype=np.float32)
    expect = ((x + 0.055) / 1.055) ** 2.4
    got = np.asarray(color.srgb_to_linear(jnp.asarray(x)))
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_linear_to_srgb_piecewise():
    lo = 0.001
    assert np.isclose(float(color.linear_to_srgb(lo)), 12.92 * lo, rtol=1e-6)
    hi = 0.5
    assert np.isclose(
        float(color.linear_to_srgb(hi)), 1.055 * hi ** (1 / 2.4) - 0.055, rtol=1e-5
    )
    assert float(color.linear_to_srgb(0.0)) == 0.0


def test_roundtrip_monotonic():
    x = np.linspace(0, 1, 32, dtype=np.float32)
    y = np.asarray(color.linear_to_srgb(jnp.asarray(x)))
    assert (np.diff(y) > 0).all()


def test_luminance():
    assert np.isclose(float(color.luminance(jnp.array([1.0, 1.0, 1.0]))), 1.0)
    assert np.isclose(float(color.luminance(jnp.array([0.0, 1.0, 0.0]))), 0.7152)


def test_encode_u8():
    img = jnp.array([[0.0, 0.5, 2.0]])
    out = np.asarray(color.encode_u8(img))
    assert out.dtype == np.uint8
    assert out[0, 0] == 0
    assert out[0, 2] == 255  # clamped to 1.0 before encode


def test_tonemaps_bounded():
    x = jnp.linspace(0.0, 20.0, 50)
    assert float(color.aces(x).max()) <= 1.2
    r = color.reinhard(x)
    assert float(r.max()) <= 1.0 and float(r.min()) >= 0.0
