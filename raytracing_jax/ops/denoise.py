"""Firefly median denoiser.

The reference's 3x3 luminance-median filter (denoiser.c:9-127) as ONE fused
jitted image pass — the chunk/atomic-counter threading (denoiser.c:40-63)
disappears; sorting 9 elements per pixel vectorizes across the whole image
(SURVEY §2.21).

Algorithm parity:
- 9 neighborhood samples (edge-clamped), sorted by Rec.709 luminance
- median color = the luminance-median sample
- mean luminance excludes the min and max samples
- noisiness = |median_lum - mean|; blend factor =
  clamp(|median_lum - orig_lum| - 5*noisiness, 0, 0.0125) / 0.0125
- output = lerp(original, median, factor) — i.e. only luminance outliers in
  quiet neighborhoods are replaced
- operates on the 8-bit image (u8 -> f32 /255.999 -> u8), like the reference
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_jax.utils import color

DENOISING_THRESHOLD = 0.0125  # denoiser.c:9
NEIGHBOURHOOD_WEIGHT = 5.0  # denoiser.c:10


@jax.jit
def denoise_u8(img):
    """img: (H, W, 3) u8 -> (H, W, 3) u8."""
    f = img.astype(jnp.float32) * (1.0 / 255.999)

    # 3x3 edge-clamped neighborhood -> (H, W, 9, 3)
    p = jnp.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w, _ = f.shape
    stack = jnp.stack(
        [
            p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ],
        axis=2,
    )

    lum = color.luminance(stack)  # (H, W, 9)
    order = jnp.argsort(lum, axis=2)
    lum_sorted = jnp.take_along_axis(lum, order, axis=2)
    median_lum = lum_sorted[..., 4]
    median_rgb = jnp.take_along_axis(
        stack, order[..., 4:5, None], axis=2
    )[..., 0, :]

    mean = (lum.sum(axis=2) - lum_sorted[..., 0] - lum_sorted[..., 8]) / 7.0
    noisiness = jnp.abs(median_lum - mean)

    orig_rgb = stack[..., 4, :]  # center sample (dy=0, dx=0)
    orig_lum = lum[..., 4]

    diff = jnp.abs(median_lum - orig_lum) - noisiness * NEIGHBOURHOOD_WEIGHT
    t = jnp.clip(diff, 0.0, DENOISING_THRESHOLD) / DENOISING_THRESHOLD

    out = orig_rgb * (1.0 - t[..., None]) + median_rgb * t[..., None]
    return (out * 255.999).astype(jnp.uint8)
