"""Denoiser parity with a direct numpy port of the C algorithm
(denoiser.c:47-127)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_jax.ops.denoise import denoise_u8

LUMA = np.array([0.2126, 0.7152, 0.0722])


def _denoise_numpy(img):
    """Literal numpy re-statement of denoiser.c semantics for testing."""
    h, w, _ = img.shape
    f = img.astype(np.float64) / 255.999
    out = np.zeros_like(f)
    for y in range(h):
        for x in range(w):
            samples = []
            for yo in (-1, 0, 1):
                for xo in (-1, 0, 1):
                    yy = min(max(y + yo, 0), h - 1)
                    xx = min(max(x + xo, 0), w - 1)
                    c = f[yy, xx]
                    samples.append((c @ LUMA, c))
            orig_l, orig_c = samples[4]
            samples.sort(key=lambda s: s[0])
            med_l, med_c = samples[4]
            mean = sum(s[0] for s in samples[1:-1]) / 7.0
            noisiness = abs(med_l - mean)
            diff = abs(med_l - orig_l) - noisiness * 5.0
            t = min(max(diff, 0.0), 0.0125) / 0.0125
            out[y, x] = orig_c * (1 - t) + med_c * t
    return (out * 255.999).astype(np.uint8)


def test_firefly_removed_flat_region_kept():
    img = np.full((16, 16, 3), 100, np.uint8)
    img[8, 8] = 255  # firefly
    out = np.asarray(denoise_u8(jnp.asarray(img)))
    assert (out[8, 8] == 100).all()
    # far-away flat pixels untouched
    assert (out[2, 2] == 100).all()


def test_matches_numpy_port(rng):
    img = rng.integers(0, 256, (12, 14, 3), dtype=np.uint8)
    # sprinkle fireflies
    img[3, 4] = [255, 255, 255]
    img[9, 9] = [250, 240, 255]
    got = np.asarray(denoise_u8(jnp.asarray(img)))
    want = _denoise_numpy(img)
    # identical up to 1 ulp of u8 quantization (f32 vs f64 accumulation)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_shape_and_dtype():
    img = np.zeros((8, 8, 3), np.uint8)
    out = np.asarray(denoise_u8(jnp.asarray(img)))
    assert out.shape == (8, 8, 3) and out.dtype == np.uint8


def _with_fireflies(img):
    h, w, _ = img.shape
    img[h // 3, w // 2] = [255, 255, 255]
    img[(2 * h) // 3, w // 5] = [250, 255, 240]
    return img


@pytest.mark.parametrize("shape", [(24, 256), (13, 128)])
def test_wide_images_match_numpy_port(shape, rng):
    """Frames wider than tall and heights that are not a multiple of 8."""
    img = _with_fireflies(rng.integers(0, 256, shape + (3,), dtype=np.uint8))
    got = np.asarray(denoise_u8(jnp.asarray(img)))
    want = _denoise_numpy(img)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_flat_image_unchanged():
    img = np.full((16, 128, 3), 77, np.uint8)
    got = np.asarray(denoise_u8(jnp.asarray(img)))
    assert (got == 77).all()
