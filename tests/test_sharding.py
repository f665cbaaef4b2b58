"""Multi-device sharding: 8-way CPU mesh must reproduce single-device output
(SURVEY §2.11: chunks -> shards; scene replicated)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_jax.parallel import mesh as mesh_mod
from raytracing_jax.render.renderer import render, render_batch

from helpers import random_mesh, simple_scene


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    return simple_scene(random_mesh(200, rng))


def test_mesh_has_8_devices():
    m = mesh_mod.make_mesh()
    assert int(np.prod(list(m.shape.values()))) == 8


def test_sharded_batch_matches_single(scene):
    m = mesh_mod.make_mesh()
    px = jnp.arange(256, dtype=jnp.int32) % 16
    py = jnp.arange(256, dtype=jnp.int32) // 16
    key = jax.random.PRNGKey(3)

    kwargs = dict(width=16, height=16, spp=2, max_bounces=3)
    rgb_single, rays_single = render_batch(scene, px, py, key, **kwargs)

    scene_r = mesh_mod.shard_scene(scene, m)
    px_s = mesh_mod.shard_rays(px, m)
    py_s = mesh_mod.shard_rays(py, m)
    rgb_sharded, rays_sharded = render_batch(scene_r, px_s, py_s, key, **kwargs)

    np.testing.assert_allclose(
        np.asarray(rgb_single), np.asarray(rgb_sharded), rtol=1e-5, atol=1e-6
    )
    assert float(rays_single) == float(rays_sharded)


def test_render_with_mesh(scene):
    m = mesh_mod.make_mesh()
    # dense loop: each device renders whole batches with the single-device
    # per-batch RNG stream, so the image is bit-identical
    img_m, stats_m = render(
        scene, 24, 16, spp=2, max_bounces=3, seed=5, mesh=m, compact=False
    )
    img_s, stats_s = render(
        scene, 24, 16, spp=2, max_bounces=3, seed=5, compact=False
    )
    assert img_m.shape == (16, 24, 3)
    np.testing.assert_array_equal(img_m, img_s)


def test_render_with_mesh_compacted(scene):
    """compact=True under a mesh: each device compacts and renders whole
    batches with the single-device per-batch keys, so the image is
    bit-identical to the single-device render."""
    m = mesh_mod.make_mesh()
    kw = dict(spp=8, max_bounces=4, seed=5, batch_pixels=128)
    img_m, st_m = render(scene, 32, 32, mesh=m, **kw)
    img_s, st_s = render(scene, 32, 32, **kw)
    np.testing.assert_array_equal(img_m, img_s)
    assert st_m.rays_traced == st_s.rays_traced


def test_render_with_mesh4_stack_kernel(scene):
    """The stack kernel under shard_map on a 4-device mesh (interpret
    mode): scene replicated, one batch per device; the dense loop stays
    bit-identical to the single-device render."""
    m = mesh_mod.make_mesh(jax.devices()[:4])
    kw = dict(spp=1, max_bounces=2, seed=3, compact=False, method="stack",
              interpret=True, batch_pixels=64)
    img_m, _ = render(scene, 16, 16, mesh=m, **kw)
    img_s, _ = render(scene, 16, 16, **kw)
    np.testing.assert_array_equal(img_m, img_s)
    assert img_m.std() > 0


def test_render_with_mesh_nee(scene):
    """NEE under shard_map: shadow rays + MIS weights ride the per-device
    trace with the single-device per-batch streams, so the sharded image
    is bit-identical to single-device."""
    m = mesh_mod.make_mesh()
    kw = dict(spp=2, max_bounces=3, seed=5, compact=False, nee=True)
    img_m, stats_m = render(scene, 24, 16, mesh=m, **kw)
    img_s, stats_s = render(scene, 24, 16, **kw)
    np.testing.assert_array_equal(img_m, img_s)
    # NEE's shadow rays are counted per batch on every device
    assert stats_m.rays_traced == stats_s.rays_traced
    assert stats_m.rays_traced > 24 * 16 * 2  # shadow rays present
