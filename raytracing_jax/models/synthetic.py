"""Seeded scenes with the shapes of real workloads, built without assets.

`helmet_like` has the shapes of the glTF DamagedHelmet workload
(BASELINE.md: 15,452 textured triangles, four 2048^2 textures, env-lit,
rendered at 1920x1080): a displaced shell, a visor and a collar, with UVs
and tangents, four Disney materials (one emissive), four 2048^2 RGB
textures (albedo, normal, metallic-roughness, emission) and an equirect
environment map. The same seed gives the same scene.
"""

from __future__ import annotations

import numpy as np

from raytracing_jax.io.materials import (
    AtlasBuilder, HostMaterial, build_material_table,
)
from raytracing_jax.models.scene import (
    Background, Camera, HostMesh, build_scene,
)

#: (u segments, v segments) of each part; triangles = 2 * u * v
SHELL = (96, 64)
VISOR = (48, 24)
COLLAR = (43, 10)
N_TRIANGLES = 2 * sum(a * b for a, b in (SHELL, VISOR, COLLAR))  # 15,452
TEX_SIZE = 2048
ENV_SIZE = (1024, 512)
WIDTH, HEIGHT = 1920, 1080


def _grid_mesh(pos_fn, nu, nv, uv_rect, mat):
    """Triangulated (nu x nv) parametric patch. pos_fn maps (s, t) in
    [0, 1]^2 grids to (..., 3) points; normals are the mesh's own area-
    weighted vertex normals; UVs map into uv_rect = (u0, v0, u1, v1)."""
    s, t = np.meshgrid(
        np.linspace(0.0, 1.0, nu + 1), np.linspace(0.0, 1.0, nv + 1),
        indexing="ij",
    )
    p = pos_fn(s, t)  # (nu+1, nv+1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i, j)
    b = (i + 1, j)
    c = (i + 1, j + 1)
    d = (i, j + 1)
    tri = np.stack(
        [np.stack([a, b, c], -1), np.stack([a, c, d], -1)], 2
    ).reshape(2, -1, 3)  # (2 = i/j, n, 3 corners)
    ti, tj = tri[0], tri[1]
    pos = p[ti, tj]  # (n, 3, 3)

    fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    vn = np.zeros_like(p)
    for k in range(3):
        np.add.at(vn, (ti[:, k], tj[:, k]), fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    u0, v0, u1, v1 = uv_rect
    uv = np.stack([u0 + (u1 - u0) * s, v0 + (v1 - v0) * t], -1)
    return (
        pos.astype(np.float32),
        vn[ti, tj].astype(np.float32),
        uv[ti, tj].astype(np.float32),
        np.full(len(pos), mat, np.int32),
    )


def _noise2d(rng, size, cells):
    """Smooth value noise in [0, 1]: a (cells x cells) random lattice,
    bilinearly upsampled to (size x size)."""
    lat = rng.random((cells + 1, cells + 1))
    x = np.linspace(0.0, cells, size, endpoint=False)
    i = x.astype(np.int64)
    f = (x - i)[:, None]
    rows = lat[i] * (1.0 - f) + lat[i + 1] * f  # (size, cells+1)
    g = (x - i)[None, :]
    return rows[:, i] * (1.0 - g) + rows[:, i + 1] * g


def _textures(rng, size):
    """Four RGB u8 textures: albedo, tangent-space normal map,
    metallic-roughness (glTF channels: G roughness, B metalness) and
    emission."""
    n1 = _noise2d(rng, size, 32)
    n2 = _noise2d(rng, size, 128)
    scratch = (_noise2d(rng, size, 512) > 0.93).astype(np.float64)
    yy, xx = np.mgrid[0:size, 0:size]
    panels = (((xx // 128) + (yy // 128)) % 2).astype(np.float64)

    def u8(a):
        return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)

    albedo = np.stack(
        [0.35 + 0.3 * n1 + 0.1 * panels, 0.33 + 0.25 * n1,
         0.3 + 0.2 * n2], -1,
    ) * (1.0 - 0.5 * scratch[..., None])
    hx = np.gradient(n2, axis=1) * 40.0
    hy = np.gradient(n2, axis=0) * 40.0
    nz = 1.0 / np.sqrt(1.0 + hx * hx + hy * hy)
    normal = np.stack([-hx * nz, -hy * nz, nz], -1) * 0.5 + 0.5
    mr = np.stack(
        [np.ones_like(n1), 0.2 + 0.7 * n2, 0.3 + 0.6 * panels * n1], -1
    )
    glow = ((yy % 256) < 12).astype(np.float64) * (0.6 + 0.4 * n1)
    emission = np.stack([glow, 0.8 * glow, 0.3 * glow], -1)
    return [u8(a) for a in (albedo, normal, mr, emission)]


def _env_map(rng, w, h):
    """Equirect sky: a horizon gradient, cloud noise and a bright sun."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    sky = np.clip(1.0 - v, 0.0, 1.0)[:, None, None] * np.array(
        [0.35, 0.55, 0.9]
    ) + 0.15
    clouds = _noise2d(rng, w, 16)[:h, :, None] * 0.3
    theta = np.pi * v[:, None]
    phi = 2.0 * np.pi * u[None, :]
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.broadcast_to(np.cos(theta), (h, w)),
         np.sin(theta) * np.sin(phi)], -1,
    )
    sun_dir = np.array([0.5, 0.75, 0.43])
    sun_dir /= np.linalg.norm(sun_dir)
    sun = (d @ sun_dir > 0.995).astype(np.float64)[..., None]
    img = np.clip(sky + clouds, 0.0, 1.0) * (1.0 - sun) + sun
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world matrix looking from eye to target (-z forward)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, -f, eye
    return m.astype(np.float32)


def helmet_like_host(seed: int = 0, tex_size: int = TEX_SIZE,
                     env_size=ENV_SIZE):
    """Host-side staging: (HostMesh, [HostMaterial], AtlasBuilder,
    env texture id, Camera)."""
    rng = np.random.default_rng(seed)
    bumps = rng.normal(0.0, 1.0, (6, 3))

    def shell(s, t):
        th = np.pi * (0.08 + 0.84 * t)
        ph = 2.0 * np.pi * s
        d = np.stack(
            [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)],
            -1,
        )
        r = 1.0 + 0.04 * sum(
            np.sin(3.0 * d @ b + k) for k, b in enumerate(bumps)
        )
        return d * r[..., None] * np.array([1.0, 1.1, 1.05])

    def visor(s, t):
        th = np.pi * (0.35 + 0.25 * t)
        ph = np.pi * (0.25 + 0.5 * s)
        d = np.stack(
            [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)],
            -1,
        )
        return d * 1.12 + np.array([0.0, 0.0, 0.02])

    def collar(s, t):
        ph = 2.0 * np.pi * s
        a = 2.0 * np.pi * t
        rr = 0.75 + 0.12 * np.cos(a)
        return np.stack(
            [rr * np.cos(ph), -1.0 + 0.12 * np.sin(a), rr * np.sin(ph)], -1
        )

    parts = [
        _grid_mesh(shell, *SHELL, (0.0, 0.0, 1.0, 0.5), 0),
        _grid_mesh(visor, *VISOR, (0.0, 0.5, 0.5, 1.0), 1),
        _grid_mesh(collar, *COLLAR, (0.5, 0.5, 1.0, 0.75), 2),
    ]
    pos, nrm, uv, mat = (np.concatenate(x) for x in zip(*parts))
    # the collar's outer band glows (material 3)
    band = (mat == 2) & (pos[:, :, 1].mean(axis=1) < -1.05)
    mat = np.where(band, 3, mat).astype(np.int32)
    mesh = HostMesh(positions=pos, normals=nrm, uvs=uv, mat_id=mat)

    atlas = AtlasBuilder()
    alb, nmap, mr, emi = (atlas.add(t) for t in _textures(rng, tex_size))
    env = atlas.add(_env_map(rng, *env_size))
    mats = [
        HostMaterial(name="shell", base_color=(1.0, 1.0, 1.0),
                     roughness=1.0, metalness=1.0, tex_albedo=alb,
                     tex_normal=nmap, normal_strength=1.0, tex_mr=mr),
        HostMaterial(name="visor", base_color=(0.9, 0.7, 0.3),
                     roughness=0.08, metalness=1.0, tex_normal=nmap,
                     normal_strength=0.3),
        HostMaterial(name="collar", base_color=(0.2, 0.25, 0.3),
                     roughness=0.6, sheen=0.8, sheen_tint=0.5,
                     anisotropic=0.5, tex_albedo=alb),
        HostMaterial(name="glow", base_color=(0.1, 0.1, 0.1),
                     emission=(4.0, 4.0, 4.0), tex_emission=emi),
    ]
    view = _look_at((1.4, 0.5, 2.9), (0.0, 0.0, 0.0))
    fov = np.float32(np.deg2rad(45.0))
    import jax.numpy as jnp

    camera = Camera(
        view_matrix=jnp.asarray(view), fov=jnp.float32(fov),
        focal_length=jnp.float32(1.0 / np.tan(fov * 0.5)),
    )
    return mesh, mats, atlas, env, camera


def helmet_like(seed: int = 0, tex_size: int = TEX_SIZE, env_size=ENV_SIZE):
    """The helmet-scale scene, built (BVH, tables, env-light CDF)."""
    mesh, mats, atlas, env, camera = helmet_like_host(seed, tex_size,
                                                      env_size)
    return build_scene(
        mesh,
        materials=build_material_table(mats),
        atlas=atlas.build(),
        background=Background.equirect(env),
        camera=camera,
    )
