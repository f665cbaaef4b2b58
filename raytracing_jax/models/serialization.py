"""Scene cache: versioned binary save/load.

Capability parity with scene_save_writer / scene_load_bytes (scene.c:13-76):
a versioned header {version, n_nodes, n_triangles, bvh_depth, camera} plus
the raw node and triangle arrays. The container is npz with one entry per
component plane (a golden layout with named arrays instead of the
reference's zero-copy pointer fixup — device arrays get re-uploaded on load
anyway, so mmap aliasing buys nothing here).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracing_jax.models.scene import (
    BG_EQUIRECT,
    BVH,
    Background,
    Camera,
    MaterialTable,
    Scene,
    Spheres,
    TextureAtlas,
    Triangles,
)
from raytracing_jax.utils.vec3 import Vec3

FORMAT_VERSION = 4  # v4: the bf16 node twin is gone

_TRI_VEC = ("v0", "e1", "e2", "n0", "n1", "n2", "ng", "tangent", "bitangent")
_TRI_SCALAR = (
    "uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v", "mat_id",
    "leaf_rows", "attr_rows",
)
_MAT_VEC = ("base_color", "emission")
_MAT_SCALAR = (
    "roughness", "metalness", "normal_strength", "sheen", "sheen_tint",
    "anisotropic", "tex_albedo", "tex_normal", "tex_mr", "tex_emission",
    "shader_kind", "rows",
)
_ATLAS = ("tex_r", "tex_g", "tex_b", "offset", "width", "height", "pages")


def _save_vec3(data: dict, prefix: str, v: Vec3) -> None:
    data[f"{prefix}_x"] = np.asarray(v.x)
    data[f"{prefix}_y"] = np.asarray(v.y)
    data[f"{prefix}_z"] = np.asarray(v.z)


def _load_vec3(z, prefix: str) -> Vec3:
    return Vec3(
        x=jnp.asarray(z[f"{prefix}_x"]),
        y=jnp.asarray(z[f"{prefix}_y"]),
        z=jnp.asarray(z[f"{prefix}_z"]),
    )


def save_scene_cache(path: str, scene: Scene) -> None:
    data = {
        "header": np.array(
            [
                FORMAT_VERSION,
                scene.bvh.n_internal,
                scene.n_triangles,
                scene.bvh.depth,
                scene.bvh.last_row_offset,
                scene.background.kind,
                scene.background.tex_id,
            ],
            np.int64,
        ),
        "camera_view": np.asarray(scene.camera.view_matrix),
        "camera_fov": np.asarray(scene.camera.fov),
        "camera_focal": np.asarray(scene.camera.focal_length),
        "bvh_nodes": np.asarray(scene.bvh.nodes),
        "bg_color": np.asarray(scene.background.color),
        "sph_radius": np.asarray(scene.spheres.radius),
        "sph_mat_id": np.asarray(scene.spheres.mat_id),
    }
    for f in _TRI_VEC:
        _save_vec3(data, f"tri_{f}", getattr(scene.triangles, f))
    for f in _TRI_SCALAR:
        data[f"tri_{f}"] = np.asarray(getattr(scene.triangles, f))
    for f in _MAT_VEC:
        _save_vec3(data, f"mat_{f}", getattr(scene.materials, f))
    for f in _MAT_SCALAR:
        data[f"mat_{f}"] = np.asarray(getattr(scene.materials, f))
    for f in _ATLAS:
        data[f"atlas_{f}"] = np.asarray(getattr(scene.atlas, f))
    _save_vec3(data, "sph_center", scene.spheres.center)
    np.savez_compressed(path, **data)


def load_scene_cache(path: str) -> Scene:
    z = np.load(path)
    header = z["header"]
    version = int(header[0])
    if version != FORMAT_VERSION:
        raise ValueError(f"scene cache version {version} != {FORMAT_VERSION}")
    (_, n_nodes, n_triangles, depth, last_row_offset, bg_kind, bg_tex) = (
        int(x) for x in header
    )

    bvh = BVH(
        nodes=jnp.asarray(z["bvh_nodes"]),
        depth=depth,
        last_row_offset=last_row_offset,
    )
    assert bvh.n_internal == n_nodes

    tris = Triangles(
        **{f: _load_vec3(z, f"tri_{f}") for f in _TRI_VEC},
        **{f: jnp.asarray(z[f"tri_{f}"]) for f in _TRI_SCALAR},
    )
    mats = MaterialTable(
        **{f: _load_vec3(z, f"mat_{f}") for f in _MAT_VEC},
        **{f: jnp.asarray(z[f"mat_{f}"]) for f in _MAT_SCALAR},
    )
    # tiled pages are DERIVED from the stored flat texels (format unchanged)
    atlas = TextureAtlas(
        **{f: jnp.asarray(z[f"atlas_{f}"]) for f in _ATLAS}
    ).with_tiles()
    spheres = Spheres(
        center=_load_vec3(z, "sph_center"),
        radius=jnp.asarray(z["sph_radius"]),
        mat_id=jnp.asarray(z["sph_mat_id"]),
    )
    camera = Camera(
        view_matrix=jnp.asarray(z["camera_view"]),
        fov=jnp.asarray(z["camera_fov"]),
        focal_length=jnp.asarray(z["camera_focal"]),
    )
    background = Background(
        kind=bg_kind, color=jnp.asarray(z["bg_color"]), tex_id=bg_tex
    )
    env = None
    if bg_kind == BG_EQUIRECT and int(bg_tex) >= 0:
        from raytracing_jax.ops.env_light import build_env_light

        env = build_env_light(atlas, int(bg_tex))
    return Scene(
        triangles=tris,
        bvh=bvh,
        materials=mats,
        atlas=atlas,
        spheres=spheres,
        background=background,
        camera=camera,
        n_triangles=n_triangles,
        env_light=env,
    )
