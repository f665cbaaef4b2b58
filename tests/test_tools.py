"""Tooling: BVH wireframe dump (visualizer parity, SURVEY §2.23)."""

import os
import sys

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
)

from helpers import random_mesh, simple_scene


def test_bvh_dump_obj(tmp_path, rng):
    from bvh_viz import dump_bvh_obj

    scene = simple_scene(random_mesh(200, rng))
    out = str(tmp_path / "bvh.obj")
    stats = dump_bvh_obj(scene, out)
    assert os.path.exists(out)
    # depth-2 scene: level 0 has <= 8 boxes, level 1 more
    assert set(stats) == set(range(scene.bvh.depth))
    assert 0 < stats[0] <= 8
    text = open(out).read()
    assert "o level_0" in text and "l " in text and "v " in text
    # every box contributes 8 vertices and 12 line segments
    n_boxes = sum(stats.values())
    assert text.count("\nv ") == n_boxes * 8
    assert text.count("\nl ") == n_boxes * 12


def test_bvh_interactive_snapshot(tmp_path, rng):
    """--interactive's frame renderer (headless --snapshot form): one level
    of wireframe boxes rasterized with the orbit camera, non-empty image."""
    from bvh_viz import interactive

    scene = simple_scene(random_mesh(200, rng))
    out = str(tmp_path / "snap.png")
    interactive(scene, snapshot=out)
    from raytracing_jax.io.image_io import load_image_rgb_u8

    a = load_image_rgb_u8(out)
    assert a.shape == (512, 512, 3)
    assert (a > 0).mean() > 0.001  # wireframes actually drawn
