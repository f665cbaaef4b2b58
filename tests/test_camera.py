"""Camera raygen semantics (reference raytracer.c:612, 641-698)."""

import numpy as np
import jax.numpy as jnp

from raytracing_jax.models.scene import Camera
from raytracing_jax.render.camera import generate_rays


def _rays(cam, w, h, px, py, jx=0.5, jy=0.5):
    px = jnp.asarray(np.atleast_1d(px), jnp.int32)
    py = jnp.asarray(np.atleast_1d(py), jnp.int32)
    ju = jnp.full((px.shape[0],), jx, jnp.float32)
    jv = jnp.full((px.shape[0],), jy, jnp.float32)
    o, d = generate_rays(cam, w, h, px, py, ju, jv)
    return np.asarray(o.to_array()), np.asarray(d.to_array())


def test_center_ray_points_forward():
    cam = Camera.default()
    w = h = 128
    # pixel center of the image: uv = 0 requires x + jitter - 0.5 = w/2
    o, d = _rays(cam, w, h, w // 2, h // 2)
    assert np.allclose(o[0], [0, 0, 3])
    assert np.allclose(d[0], [0, 0, -1], atol=1e-6)


def test_fov_edge_angle():
    cam = Camera.default()  # fov 70deg
    w = h = 128
    # right edge: u -> +1, so tan(theta_x) = aspect / focal = tan(35deg)
    o, d = _rays(cam, w, h, w, h // 2)
    theta = np.degrees(np.arctan2(d[0, 0], -d[0, 2]))
    assert np.isclose(theta, 35.0, atol=0.1)
    # y is flipped: bottom of the image (py = h) looks down
    o, d = _rays(cam, w, h, w // 2, h)
    assert d[0, 1] < 0


def test_view_matrix_rotation_applied():
    # rotation mapping camera-forward (-z) to +x world, translation (5,0,0)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
    m[:3, 3] = [5, 0, 0]
    cam = Camera(
        view_matrix=jnp.asarray(m),
        fov=jnp.float32(1.0),
        focal_length=jnp.float32(1.0 / np.tan(0.5)),
    )
    o, d = _rays(cam, 64, 64, 32, 32)
    assert np.allclose(o[0], [5, 0, 0])
    assert np.allclose(d[0], [1, 0, 0], atol=1e-6)


def test_direction_normalized():
    cam = Camera.default()
    px = np.arange(16) * 4
    py = np.arange(16) * 3
    _, d = _rays(cam, 64, 64, px, py)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
