"""Environment background shading (miss rays).

Equirect mapping u = 0.5 + atan2(z, x)/2pi, v = 0.5 - asin(y)/pi with a
bilinear sample and sRGB->linear decode, matching sample_background
(driver.c:95-104); or a constant linear color. Component-plane in/out.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracing_jax.models.scene import BG_EQUIRECT
from raytracing_jax.ops import texture
from raytracing_jax.utils import color
from raytracing_jax.utils.vec3 import Vec3


def eval_background(scene, direction: Vec3) -> Vec3:
    """Background radiance for unit directions (Vec3 of (R,)) -> linear
    RGB Vec3."""
    bg = scene.background
    r = direction.shape[0]
    if bg.kind == BG_EQUIRECT and bg.tex_id >= 0:
        u = 0.5 + jnp.arctan2(direction.z, direction.x) * (0.5 / jnp.pi)
        v = 0.5 - jnp.arcsin(jnp.clip(direction.y, -1.0, 1.0)) * (1.0 / jnp.pi)
        tid = jnp.full((r,), bg.tex_id, jnp.int32)
        rgb = texture.sample_bilinear(scene.atlas, tid, u, v)
        return rgb.map(color.srgb_to_linear)
    return Vec3(
        x=jnp.broadcast_to(bg.color[0], (r,)),
        y=jnp.broadcast_to(bg.color[1], (r,)),
        z=jnp.broadcast_to(bg.color[2], (r,)),
    )
