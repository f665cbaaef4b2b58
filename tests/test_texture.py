"""Texture sampling: tiled-page fast path vs the flat-page reference path.

The tiled layout (models/scene.py TILE_W/TILE_H: 13x8-texel tiles with a
one-texel clamp apron, 126 of 128 lanes) exists purely to turn a bilinear
tap's 4 page-row gathers into 1; the fetched texels must be IDENTICAL —
including the reference's wrap (negative-UV fixup) and +1-texel edge
clamp semantics (driver.c:32-38, 66-67), which the apron bakes in at pack
time. Sizes below cover: smaller than one tile, exact tile multiples,
one-past-a-tile, wide-and-short, and the 1x1 dummy.
"""

import numpy as np
import jax.numpy as jnp

from raytracing_jax.io.materials import AtlasBuilder
from raytracing_jax.ops import texture

SIZES = [(7, 5), (64, 48), (100, 257), (1, 1), (8, 13), (9, 14), (3, 200)]


def test_tiled_matches_flat_pages(rng):
    b = AtlasBuilder()
    for (h, w) in SIZES:
        b.add(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    atlas = b.build()
    assert atlas.tpages is not None
    flat = atlas.replace(tpages=None)  # forces the 4-gather fallback path

    r = 4096
    uu = jnp.asarray(rng.uniform(-2.0, 2.0, r).astype(np.float32))
    vv = jnp.asarray(rng.uniform(-2.0, 2.0, r).astype(np.float32))
    for tid_v in range(len(SIZES) + 1):  # +1: the reserved 1x1 white dummy
        tid = jnp.full((r,), tid_v, jnp.int32)
        for mode in ("nearest", "bilinear"):
            got = texture.sample(atlas, tid, uu, vv, mode)
            want = texture.sample(flat, tid, uu, vv, mode)
            for c in "xyz":
                np.testing.assert_array_equal(
                    np.asarray(getattr(got, c)),
                    np.asarray(getattr(want, c)),
                    err_msg=f"tex {tid_v} {mode} {c}",
                )
