"""Equirect environment background (reference sample_background,
driver.c:95-104) — end-to-end through the loader and the integrator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_jax.io.image_io import write_png
from raytracing_jax.io.loader import load_scene
from raytracing_jax.ops.background import eval_background
from raytracing_jax.utils.color import srgb_to_linear

from helpers import vec3_of

MODELS = "/root/reference/models"


@pytest.fixture
def env_scene(tmp_path):
    # equirect map: left half (u<0.5) red, right half green; u=0.5+atan2/2pi
    img = np.zeros((2, 8, 3), np.uint8)
    img[:, :4] = [200, 10, 10]
    img[:, 4:] = [10, 200, 10]
    bg = str(tmp_path / "background.png")
    write_png(bg, img)
    return load_scene(f"{MODELS}/quad.obj", background_path=bg,
                      warn=lambda *a: None)


def test_equirect_directional_lookup(env_scene):
    scene = env_scene
    assert scene.background.kind == 1  # BG_EQUIRECT
    # -x direction: atan2(0,-1)=pi -> u=1.0 (right half, green);
    # +x direction: atan2(0,1)=0 -> u=0.5 (green side boundary+);
    # use +z/-z to hit u=0.75 / 0.25 cleanly
    d = vec3_of([[0, 0, 1], [0, 0, -1]])  # u=0.75 (green), u=0.25 (red)
    rgb = eval_background(scene, d)
    out = np.asarray(rgb.to_array())
    green = float(srgb_to_linear(jnp.float32(200 / 255.999)))
    red = float(srgb_to_linear(jnp.float32(10 / 255.999)))
    np.testing.assert_allclose(out[0], [red, green, red], atol=0.02)
    np.testing.assert_allclose(out[1], [green, red, red], atol=0.02)


def test_missing_env_map_is_fatal(tmp_path):
    """Reference load_texture parity (driver.c:106-116): a missing env map
    exits with 'Failed to load texture', never a silent fallback."""
    with pytest.raises(FileNotFoundError, match="Failed to load texture"):
        load_scene(
            f"{MODELS}/quad.obj",
            background_path=str(tmp_path / "nope.png"),
            warn=lambda *a: None,
        )


def test_missing_env_map_cli_exit(tmp_path, capsys):
    """CLI surface of the same parity: exit code 1 + the message on
    stderr (driver.c:113-115)."""
    from raytracing_jax.cli import main

    rc = main(["-W", "8", "-H", "8", "-S", "1",
               "--bg", str(tmp_path / "nope.png"),
               f"{MODELS}/quad.obj", "-O", str(tmp_path / "o.png")])
    assert rc == 1
    assert "Failed to load texture" in capsys.readouterr().err


def test_no_bg_flag_uses_constant_sky():
    scene = load_scene(f"{MODELS}/quad.obj", background_path=None,
                       warn=lambda *a: None)
    assert scene.background.kind == 0  # BG_CONSTANT


def test_miss_rays_collect_env_light(env_scene):
    from raytracing_jax.render import integrator

    o = vec3_of([[5, 5, 5]])
    d = vec3_of([[0, 0, 1]])
    uni = jax.random.uniform(jax.random.PRNGKey(0), (2, 4, 1))
    rad, _ = integrator.trace(env_scene, o, d, uni, 2, method="brute")
    out = np.asarray(rad.to_array())[0]
    assert out[1] > out[0]  # +z looks at the green half
