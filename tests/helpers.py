"""Shared test scene builders."""

from __future__ import annotations

import numpy as np

from raytracing_jax.models.scene import (
    Background,
    Camera,
    HostMesh,
    MaterialTable,
    Spheres,
    TextureAtlas,
    build_scene,
)


def random_mesh(n: int, rng: np.random.Generator, extent: float = 1.0) -> HostMesh:
    """Random triangle soup in [-extent, extent]^3 with small triangles."""
    centers = rng.uniform(-extent, extent, (n, 1, 3))
    offsets = rng.normal(0.0, 0.12 * extent, (n, 3, 3))
    positions = (centers + offsets).astype(np.float32)
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    ng = np.cross(e1, e2)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(ng[:, None, :], 3, axis=1).astype(np.float32)
    uvs = rng.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    return HostMesh(
        positions=positions,
        normals=normals,
        uvs=uvs,
        mat_id=np.zeros(n, np.int32),
    )


def random_rays(r: int, rng: np.random.Generator, extent: float = 1.0):
    origin = rng.uniform(-2.5 * extent, 2.5 * extent, (r, 3)).astype(np.float32)
    direction = rng.normal(0, 1, (r, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    return origin, direction


def simple_scene(mesh: HostMesh, bg=(0.5, 0.6, 0.7), spheres: Spheres | None = None):
    return build_scene(
        mesh,
        materials=MaterialTable.default(int(mesh.mat_id.max()) + 1 if len(mesh.mat_id) else 1),
        atlas=TextureAtlas.empty(),
        background=Background.constant(bg),
        camera=Camera.default(),
        spheres=spheres,
    )


def quad_mesh(z: float = 0.0, half: float = 1.0) -> HostMesh:
    """Two triangles forming a quad in the z=`z` plane facing +z."""
    p = np.array(
        [
            [[-half, -half, z], [half, -half, z], [half, half, z]],
            [[-half, -half, z], [half, half, z], [-half, half, z]],
        ],
        np.float32,
    )
    n = np.zeros((2, 3, 3), np.float32)
    n[..., 2] = 1.0
    uv = np.array(
        [
            [[0, 0], [1, 0], [1, 1]],
            [[0, 0], [1, 1], [0, 1]],
        ],
        np.float32,
    )
    return HostMesh(positions=p, normals=n, uvs=uv, mat_id=np.zeros(2, np.int32))


def vec3_of(a):
    """(R, 3) numpy -> Vec3 of (R,) jnp planes (test convenience)."""
    import jax.numpy as jnp

    from raytracing_jax.utils.vec3 import Vec3

    a = np.asarray(a, np.float32).reshape(-1, 3)
    return Vec3(
        x=jnp.asarray(a[:, 0]), y=jnp.asarray(a[:, 1]), z=jnp.asarray(a[:, 2])
    )
