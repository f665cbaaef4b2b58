"""Scene cache roundtrip (reference scene.c:13-76 capability parity)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_jax.models import serialization

from helpers import random_mesh, simple_scene


def test_roundtrip_identical(tmp_path, rng):
    scene = simple_scene(random_mesh(100, rng))
    path = str(tmp_path / "scene.npz")
    serialization.save_scene_cache(path, scene)
    loaded = serialization.load_scene_cache(path)

    assert loaded.n_triangles == scene.n_triangles
    assert loaded.bvh.depth == scene.bvh.depth
    assert loaded.bvh.last_row_offset == scene.bvh.last_row_offset
    assert loaded.background.kind == scene.background.kind

    for a, b in zip(jax.tree.leaves(scene), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_version_check(tmp_path, rng):
    scene = simple_scene(random_mesh(16, rng))
    path = str(tmp_path / "scene.npz")
    serialization.save_scene_cache(path, scene)

    z = dict(np.load(path).items())
    z["header"] = z["header"].copy()
    z["header"][0] = 999
    np.savez(path, **z)
    with pytest.raises(ValueError, match="version"):
        serialization.load_scene_cache(path)


def test_loaded_scene_renders_same(tmp_path, rng):
    from raytracing_jax.render.renderer import render_batch

    scene = simple_scene(random_mesh(64, rng))
    path = str(tmp_path / "scene.npz")
    serialization.save_scene_cache(path, scene)
    loaded = serialization.load_scene_cache(path)

    px = jnp.arange(64, dtype=jnp.int32) % 8
    py = jnp.arange(64, dtype=jnp.int32) // 8
    key = jax.random.PRNGKey(7)
    a, _ = render_batch(scene, px, py, key, width=8, height=8, spp=2, max_bounces=3)
    b, _ = render_batch(loaded, px, py, key, width=8, height=8, spp=2, max_bounces=3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
