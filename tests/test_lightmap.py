"""Lightmap baker (reference raytracer.c:722-784 capability)."""

import numpy as np

from raytracing_jax.render.lightmap import bake_lightmap

from helpers import quad_mesh, simple_scene


def test_quad_lightmap_covered_and_lit():
    scene = simple_scene(quad_mesh(), bg=(1.0, 1.0, 1.0))
    lm = bake_lightmap(scene, 16, 16, samples=8, max_bounces=2, seed=0)
    assert lm.shape == (16, 16, 3)
    assert np.isfinite(lm).all()
    # the quad's UVs span [0,1]^2 -> every texel is rasterized, and an
    # upward-facing surface under a white sky collects positive irradiance
    assert (lm > 0).mean() > 0.95
    # cosine-weighted white-sky irradiance stays bounded
    assert lm.max() < 4.0


def test_lightmap_texels_outside_uv_stay_zero():
    mesh = quad_mesh()
    mesh.uvs = mesh.uvs * 0.5  # quad only covers the lower-left UV quadrant
    scene = simple_scene(mesh, bg=(1.0, 1.0, 1.0))
    lm = bake_lightmap(scene, 16, 16, samples=4, max_bounces=2, seed=0)
    assert (lm[12:, 12:] == 0).all()
    assert (lm[:8, :8] > 0).any()
