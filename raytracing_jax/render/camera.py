"""Pinhole camera ray generation (component-plane output).

Replicates the reference's raygen semantics (raytracer.c:641-698): jittered
uv in [-1, 1], aspect scaling on x, y flip, -focal_length forward, rotation
by the view matrix's upper-left 3x3, camera position = view_matrix * (0,0,0,1)
(raytracer.c:612).

Deliberate deviations (SURVEY §7 "quirks to not replicate"): x/y jitter are
independent uniforms (the reference computes rand_a and rand_b from identical
inputs, correlating jitter on the diagonal, raytracer.c:644-651), and
directions are normalized in full precision rather than with the approximate
rsqrt (raytracer.c:663).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracing_jax.utils.vec3 import Vec3


def generate_rays(camera, width, height, px, py, jitter_u, jitter_v):
    """Generate camera rays.

    px/py: (R,) pixel integer coordinates; jitter_u/jitter_v: (R,) uniforms
    in [0,1). Returns (origin, direction): Vec3 of (R,), unit directions.
    """
    width = jnp.float32(width)
    height = jnp.float32(height)
    aspect = width / height

    u = ((px.astype(jnp.float32) + jitter_u - 0.5) * 2.0 / width) - 1.0
    v = ((py.astype(jnp.float32) + jitter_v - 0.5) * 2.0 / height) - 1.0

    dx = u * aspect
    dy = -v
    dz = jnp.broadcast_to(-camera.focal_length, dx.shape)

    m = camera.view_matrix
    d = Vec3(
        x=m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz,
        y=m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz,
        z=m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz,
    ).normalized()

    origin = Vec3(
        x=jnp.broadcast_to(m[0, 3], dx.shape),
        y=jnp.broadcast_to(m[1, 3], dx.shape),
        z=jnp.broadcast_to(m[2, 3], dx.shape),
    )
    return origin, d
