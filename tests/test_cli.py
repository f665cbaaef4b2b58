"""CLI flag surface (reference driver.c:420-508)."""

from raytracing_jax.cli import parse_args


def test_reference_flags():
    cfg = parse_args(
        ["-W", "640", "-H", "480", "-S", "4", "-T", "3", "-B", "2",
         "model.obj", "-O", "out.qoi", "-V", "-D"]
    )
    assert cfg["width"] == 640 and cfg["height"] == 480
    assert cfg["samples"] == 4 and cfg["max_bounces"] == 2
    assert cfg["n_threads"] == 3
    assert cfg["model"] == "model.obj"
    assert cfg["output"] == "out.qoi"
    assert cfg["verbose"] and cfg["denoise"]


def test_defaults_match_reference():
    cfg = parse_args(["m.glb"])
    # driver.c:733-742
    assert cfg["width"] == 1024 and cfg["height"] == 1024
    assert cfg["samples"] == 16 and cfg["max_bounces"] == 8
    assert cfg["n_threads"] == 1
    assert cfg["output"] == "output.png"
    assert not cfg["verbose"] and not cfg["denoise"]


def test_usage_errors():
    assert parse_args([]) is None  # no model
    assert parse_args(["-W"]) is None  # missing value
    assert parse_args(["a.obj", "b.obj"]) is None  # two models
    assert parse_args(["-X", "1", "a.obj"]) is None  # unknown flag


def test_extended_flags():
    cfg = parse_args(
        ["--seed", "7", "--no-bg", "--brute-force", "a.obj",
         "--batch-pixels", "4096", "--tonemap", "aces"]
    )
    assert cfg["seed"] == 7
    assert cfg["background"] is None
    assert cfg["brute_force"]
    assert cfg["batch_pixels"] == 4096
    assert cfg["tonemap"] == "aces"


def test_nearest_filter_flag():
    cfg = parse_args(["--nearest", "a.obj"])
    assert cfg["texture_mode"] == "nearest"
    assert parse_args(["a.obj"])["texture_mode"] == "bilinear"


def test_load_scene_without_model_ok():
    cfg = parse_args(["--load-scene", "cache.npz"])
    assert cfg is not None and cfg["load_scene"] == "cache.npz"


def test_tonemap_operates_on_float_radiance():
    """--tonemap applies to the float per-pixel radiance BEFORE the u8
    encode (reference hook placement, raytracer.c:701) — NOT as a lossy
    u8 decode->tonemap->re-encode. Sky pixels carry a known constant
    linear radiance, so their tonemapped value is exactly
    encode_u8(reinhard(bg))."""
    import jax.numpy as jnp
    import numpy as np

    from raytracing_jax.io.loader import load_scene
    from raytracing_jax.render.renderer import render
    from raytracing_jax.utils import color

    scene = load_scene("/root/reference/models/fov_test.obj",
                       background_path=None, warn=lambda *a: None)
    img, _ = render(scene, 64, 64, spp=1, max_bounces=2, seed=0,
                    tonemap="reinhard")
    bg = jnp.asarray(scene.background.color)
    expect = np.asarray(color.encode_u8(color.reinhard(bg)))
    # top-left corner is open sky (see test_golden.test_fov_test_structure)
    assert (img[0, 0] == expect).all(), (img[0, 0], expect)
