"""Device-resident scene representation — component-plane (SoA) layouts.

The reference stores the scene as SoA triangle arrays plus an implicit
complete 8-ary BVH (scene.h:44-97). That layout was designed for 8-wide SIMD
and it is kept here: every hot vector quantity is a `Vec3` of three separate
planes whose minor dimension is the batch (see utils/vec3.py) — the direct
analog of the reference's `x[3]/y[3]/z[3]` arrays (scene.h:54-60) and
Vec3x8 registers.

Other mappings:
- node i's children are `8*i + 1 + j`; children with index >=
  `last_row_offset` are leaf blocks at `(child - last_row_offset)`
  (scene.h:72-90, raytracer.c:474-476). Child AABBs live in ONE
  (n_internal, 128) ROW table (6 components x 8 children per 512-byte row),
  so a traversal step is one row gather per visited node.
- the reference's per-triangle function-pointer `Shader` (scene.h:30-42)
  becomes a per-triangle `mat_id` into a `MaterialTable`, shaded by a single
  branchless ubershader.
- textures live in three flat u8 planes (`TextureAtlas`), sampled by gather.

Everything is a pytree (utils/pytree.py); static ints are aux data.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np
from raytracing_jax.utils import pytree

from raytracing_jax import BVH_WIDTH
from raytracing_jax.utils.vec3 import Vec3

# Shader kinds (reference: disney_shader_proc driver.c:350, debug_shader_proc
# driver.c:411).
SHADER_DISNEY = 0
SHADER_DEBUG_NORMAL = 1

# Background kinds (reference Background_Proc scene.h:65-70).
BG_CONSTANT = 0
BG_EQUIRECT = 1

# Row layout of the BVH node plane table: component-major, child-minor.
# rows [c*8 + j] for c in (min.x, min.y, min.z, max.x, max.y, max.z), j in 0..7
NODE_ROWS = 48

# Column layout of Triangles.attr_rows (per-triangle shading attributes).
ATTR_N0 = 0  # 0-2   vertex normal a
ATTR_N1 = 3  # 3-5   vertex normal b
ATTR_N2 = 6  # 6-8   vertex normal c
ATTR_NG = 9  # 9-11  geometric normal
ATTR_TAN = 12  # 12-14 tangent
ATTR_BTN = 15  # 15-17 bitangent
ATTR_UV = 18  # 18-23 uv0u, uv0v, uv1u, uv1v, uv2u, uv2v
ATTR_MAT = 24  # 24    material id (stored as f32)
ATTR_COLS = 25

# Column layout of MaterialTable.rows (one row per material).
MROW_BASE = 0  # 0-2 base color
MROW_EMI = 3  # 3-5 emission
MROW_ROUGH = 6
MROW_METAL = 7
MROW_NSTR = 8
MROW_SHEEN = 9
MROW_SHEENT = 10
MROW_ANISO = 11
MROW_TEX_ALBEDO = 12  # texture ids stored as f32 (-1 = none)
MROW_TEX_NORMAL = 13
MROW_TEX_MR = 14
MROW_TEX_EMI = 15
MROW_KIND = 16
MROW_COLS = 17


@pytree.dataclass
class Camera:
    """Pinhole camera (reference scene.h:14-17). `view_matrix` is
    camera-to-world; camera position is its translation column
    (raytracer.c:612)."""

    view_matrix: Any  # (4, 4) f32
    fov: Any  # scalar f32 (radians)
    focal_length: Any  # scalar f32 = 1 / tan(fov / 2)

    @staticmethod
    def default() -> "Camera":
        """Reference default: position (0,0,3), identity rotation, 70deg fov
        (driver.c:765-767)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.0, 0.0, 3.0]
        fov = np.float32(70.0 / 360.0 * 2.0 * np.pi)
        return Camera(
            view_matrix=jnp.asarray(m),
            fov=jnp.float32(fov),
            focal_length=jnp.float32(1.0 / np.tan(fov * 0.5)),
        )


@pytree.dataclass
class Triangles:
    """Padded SoA triangle store, leaf-block-major (scene.h:44-63).

    All vector attributes are Vec3 planes of shape (N,). `e1/e2` are the
    precomputed Moller-Trumbore edges. Padding slots are all-zero, which the
    epsilon tests naturally reject (SURVEY §3.3).
    """

    v0: Vec3
    e1: Vec3
    e2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    ng: Vec3  # geometric (face) normal
    tangent: Vec3
    bitangent: Vec3
    uv0u: Any  # (N,) texture coordinates, scalar planes
    uv0v: Any
    uv1u: Any
    uv1v: Any
    uv2u: Any
    uv2v: Any
    mat_id: Any  # (N,) i32, -1 for padding slots
    #: (n_blocks, 128) f32 — one leaf block per row: 9 component groups of 8
    #: lanes [v0.x*8 | v0.y*8 | v0.z*8 | e1.* | e2.*] + 56 pad lanes; the
    #: traversals fetch a block's triangles by block id.
    leaf_rows: Any = None
    #: (capacity, 128) f32 — per-triangle shading attributes as one row:
    #: [n0 n1 n2 ng tangent bitangent](18) [uv0 uv1 uv2](6) [mat_id](1).
    #: The shade stage fetches ONE row per hit instead of ~25 per-lane
    #: gathers (see ATTR_* constants).
    attr_rows: Any = None

    @property
    def capacity(self) -> int:
        return self.mat_id.shape[0]

    def v1(self) -> Vec3:
        return self.v0 + self.e1

    def v2(self) -> Vec3:
        return self.v0 + self.e2


@pytree.dataclass
class BVH:
    """Implicit complete 8-ary BVH; internal nodes only (scene.h:72-90).

    `nodes`: (n_internal, 128) f32 ROW table — one node per 512-byte row,
    cols = component * 8 + child for components
    (min.x, min.y, min.z, max.x, max.y, max.z), lanes 48+ are padding.
    """

    nodes: Any
    depth: int = pytree.field(pytree_node=False)
    last_row_offset: int = pytree.field(pytree_node=False)

    @property
    def n_internal(self) -> int:
        return self.nodes.shape[0]

    def child_boxes_np(self):
        """(n_internal, 8, 3) mins/maxs as numpy — host-side tooling/tests."""
        t = np.asarray(self.nodes)[:, : 6 * BVH_WIDTH]
        t = t.reshape(-1, 6, BVH_WIDTH).transpose(0, 2, 1)  # (n, 8, 6)
        return np.ascontiguousarray(t[..., :3]), np.ascontiguousarray(t[..., 3:])


@pytree.dataclass
class MaterialTable:
    """PBR material parameters, struct-of-arrays (reference PBR_Shader_Data,
    driver.c:191-198). Texture ids index the TextureAtlas; -1 means none."""

    base_color: Vec3  # (M,) planes
    emission: Vec3
    roughness: Any  # (M,) f32
    metalness: Any
    normal_strength: Any
    sheen: Any
    sheen_tint: Any
    anisotropic: Any
    tex_albedo: Any  # (M,) i32
    tex_normal: Any
    tex_mr: Any
    tex_emission: Any
    shader_kind: Any  # (M,) i32
    #: (M, 128) f32 — all parameters as one row per material (MROW_* cols);
    #: the shade stage fetches ONE row per ray
    rows: Any = None

    def with_rows(self) -> "MaterialTable":
        """(Re)build the packed row table from the field arrays."""
        m = self.roughness.shape[0]
        rows = np.zeros((m, 128), np.float32)
        rows[:, MROW_BASE + 0] = np.asarray(self.base_color.x)
        rows[:, MROW_BASE + 1] = np.asarray(self.base_color.y)
        rows[:, MROW_BASE + 2] = np.asarray(self.base_color.z)
        rows[:, MROW_EMI + 0] = np.asarray(self.emission.x)
        rows[:, MROW_EMI + 1] = np.asarray(self.emission.y)
        rows[:, MROW_EMI + 2] = np.asarray(self.emission.z)
        rows[:, MROW_ROUGH] = np.asarray(self.roughness)
        rows[:, MROW_METAL] = np.asarray(self.metalness)
        rows[:, MROW_NSTR] = np.asarray(self.normal_strength)
        rows[:, MROW_SHEEN] = np.asarray(self.sheen)
        rows[:, MROW_SHEENT] = np.asarray(self.sheen_tint)
        rows[:, MROW_ANISO] = np.asarray(self.anisotropic)
        rows[:, MROW_TEX_ALBEDO] = np.asarray(self.tex_albedo)
        rows[:, MROW_TEX_NORMAL] = np.asarray(self.tex_normal)
        rows[:, MROW_TEX_MR] = np.asarray(self.tex_mr)
        rows[:, MROW_TEX_EMI] = np.asarray(self.tex_emission)
        rows[:, MROW_KIND] = np.asarray(self.shader_kind)
        return self.replace(rows=jnp.asarray(rows))

    @staticmethod
    def default(n: int = 1) -> "MaterialTable":
        """A single mid-grey diffuse material (MTL defaults, driver.c:549-556)."""
        return MaterialTable(
            base_color=Vec3.splat((0.8, 0.8, 0.8), (n,)),
            emission=Vec3.zeros((n,)),
            roughness=jnp.full((n,), 0.5, jnp.float32),
            metalness=jnp.zeros((n,), jnp.float32),
            normal_strength=jnp.zeros((n,), jnp.float32),
            sheen=jnp.zeros((n,), jnp.float32),
            sheen_tint=jnp.zeros((n,), jnp.float32),
            anisotropic=jnp.zeros((n,), jnp.float32),
            tex_albedo=jnp.full((n,), -1, jnp.int32),
            tex_normal=jnp.full((n,), -1, jnp.int32),
            tex_mr=jnp.full((n,), -1, jnp.int32),
            tex_emission=jnp.full((n,), -1, jnp.int32),
            shader_kind=jnp.zeros((n,), jnp.int32),
        ).with_rows()


#: tiled-page geometry: 13x8 logical texels per tile, stored with a
#: one-texel right/bottom apron as 14x9 = 126 of a 128-lane page row
TILE_W = 13
TILE_H = 8


@pytree.dataclass
class TextureAtlas:
    """All textures packed into three flat u8 channel planes.

    Texture k owns texels [offset[k], offset[k] + width[k]*height[k]) in
    row-major order; sampling is a flat gather per channel (replacing the
    reference's pointer-chasing samplers, driver.c:31-93). Index 0 is a 1x1 white dummy so "no texture" lanes
    gather in-bounds.
    """

    tex_r: Any  # (T,) u8
    tex_g: Any
    tex_b: Any
    offset: Any  # (K,) i32
    width: Any  # (K,) i32
    height: Any  # (K,) i32
    #: (ceil(T/128), 128) u32 — texels packed r<<16|g<<8|b in 128-lane pages;
    #: a tap fetches one page row (fast) and extracts its lane with a dense
    #: one-hot reduce instead of a per-lane gather
    pages: Any = None
    #: (N2, 128) u32 — the same texels re-packed as 13x8-texel TILES with a
    #: one-texel clamp apron (14x9 = 126 lanes per 512-byte page row), so a
    #: whole 2x2 bilinear footprint lives in ONE gathered page: a bilinear
    #: tap costs 1 row gather + 4 lane extracts instead of 4 gathers. The
    #: apron replicates edge texels, which IS the reference's bilinear
    #: edge-clamp rule (driver.c:66-67).
    tpages: Any = None
    tile_row: Any = None  # (K,) i32 — first tile page row of texture k
    tiles_x: Any = None  # (K,) i32 — tile columns of texture k

    def with_pages(self) -> "TextureAtlas":
        r = np.asarray(self.tex_r).astype(np.uint32)
        g = np.asarray(self.tex_g).astype(np.uint32)
        b = np.asarray(self.tex_b).astype(np.uint32)
        packed = (r << 16) | (g << 8) | b
        t = len(packed)
        pages = np.zeros((max((t + 127) // 128, 1), 128), np.uint32)
        pages.reshape(-1)[:t] = packed
        return self.replace(pages=jnp.asarray(pages)).with_tiles()

    def with_tiles(self) -> "TextureAtlas":
        """Derive the tiled pages (host numpy; cache loads call this —
        tpages are derived, never stored, so the disk format is
        unchanged)."""
        r = np.asarray(self.tex_r).astype(np.uint32)
        g = np.asarray(self.tex_g).astype(np.uint32)
        b = np.asarray(self.tex_b).astype(np.uint32)
        packed = (r << 16) | (g << 8) | b
        offs = np.asarray(self.offset)
        ws = np.asarray(self.width)
        hs = np.asarray(self.height)

        rows, tile_row, tiles_x = [], [], []
        for off, w, h in zip(offs, ws, hs):
            img = packed[off : off + w * h].reshape(h, w)
            tx = max((w + TILE_W - 1) // TILE_W, 1)
            ty = max((h + TILE_H - 1) // TILE_H, 1)
            ridx = np.minimum(
                np.arange(ty)[:, None] * TILE_H + np.arange(TILE_H + 1),
                h - 1,
            )  # (ty, 9): 8 rows + clamp apron
            cidx = np.minimum(
                np.arange(tx)[:, None] * TILE_W + np.arange(TILE_W + 1),
                w - 1,
            )  # (tx, 14): 13 cols + clamp apron
            tiles = img[
                ridx[:, None, :, None], cidx[None, :, None, :]
            ]  # (ty, tx, 9, 14)
            flat = tiles.reshape(ty * tx, (TILE_H + 1) * (TILE_W + 1))
            tile_row.append(sum(r_.shape[0] for r_ in rows))
            tiles_x.append(tx)
            rows.append(
                np.pad(flat, ((0, 0), (0, 128 - flat.shape[1])))
            )
        tpages = np.concatenate(rows, axis=0) if rows else np.zeros(
            (1, 128), np.uint32
        )
        return self.replace(
            tpages=jnp.asarray(tpages),
            tile_row=jnp.asarray(np.array(tile_row, np.int32)),
            tiles_x=jnp.asarray(np.array(tiles_x, np.int32)),
        )

    @staticmethod
    def empty() -> "TextureAtlas":
        one = jnp.full((1,), 255, jnp.uint8)
        return TextureAtlas(
            tex_r=one, tex_g=one, tex_b=one,
            offset=jnp.zeros((1,), jnp.int32),
            width=jnp.ones((1,), jnp.int32),
            height=jnp.ones((1,), jnp.int32),
        ).with_pages()


@pytree.dataclass
class Spheres:
    """Analytic sphere primitives (reference raytracer.h:35-42; SURVEY
    §2.8c)."""

    center: Vec3  # (S,) planes
    radius: Any  # (S,) f32
    mat_id: Any  # (S,) i32

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(
            center=Vec3.zeros((0,)),
            radius=jnp.zeros((0,), jnp.float32),
            mat_id=jnp.zeros((0,), jnp.int32),
        )

    @staticmethod
    def make(centers, radii, mat_ids) -> "Spheres":
        c = np.asarray(centers, np.float32).reshape(-1, 3)
        return Spheres(
            center=Vec3(
                x=jnp.asarray(c[:, 0]),
                y=jnp.asarray(c[:, 1]),
                z=jnp.asarray(c[:, 2]),
            ),
            radius=jnp.asarray(np.asarray(radii, np.float32)),
            mat_id=jnp.asarray(np.asarray(mat_ids, np.int32)),
        )

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@pytree.dataclass
class Background:
    """Environment light: constant color or equirect env map
    (reference sample_background driver.c:95-104)."""

    kind: int = pytree.field(pytree_node=False, default=BG_CONSTANT)
    color: Any = None  # (3,) f32 linear, for BG_CONSTANT
    tex_id: int = pytree.field(pytree_node=False, default=-1)

    @staticmethod
    def constant(rgb) -> "Background":
        return Background(
            kind=BG_CONSTANT, color=jnp.asarray(rgb, jnp.float32), tex_id=-1
        )

    @staticmethod
    def equirect(tex_id: int) -> "Background":
        return Background(
            kind=BG_EQUIRECT, color=jnp.zeros((3,), jnp.float32),
            tex_id=tex_id,
        )


@pytree.dataclass
class Scene:
    """Full scene: Scene{bvh, camera, triangles, background} (scene.h:92-97)
    plus material/texture tables and optional spheres."""

    triangles: Triangles
    bvh: BVH
    materials: MaterialTable
    atlas: TextureAtlas
    spheres: Spheres
    background: Background
    camera: Camera
    n_triangles: int = pytree.field(pytree_node=False, default=0)
    #: env-light importance-sampling tables (ops/env_light.EnvLight) for
    #: NEE/MIS over an equirect background — DERIVED from the background
    #: texture on build/load, never serialized; None for constant skies
    env_light: Any = None


# ---------------------------------------------------------------------------
# Host-side construction helpers (numpy in, pytree out)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostMesh:
    """Host-side triangle soup prior to BVH build (the analog of the
    reference's `Triangle_Slice`, scene.h:37-44)."""

    positions: np.ndarray  # (n, 3, 3) f32  [tri, vertex, xyz]
    normals: np.ndarray  # (n, 3, 3) f32
    uvs: np.ndarray  # (n, 3, 2) f32
    mat_id: np.ndarray  # (n,) i32


def compute_tangents(positions: np.ndarray, uvs: np.ndarray):
    """Face normal + per-triangle tangent/bitangent from UV deltas with the
    degenerate-UV clamp, mirroring triangles_insert (scene.c:105-155).

    Returns (ng, tangent, bitangent), each (n, 3) f32.
    """
    p0, p1, p2 = positions[:, 0], positions[:, 1], positions[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0

    ng = np.cross(e1, e2)
    ng_len = np.linalg.norm(ng, axis=-1, keepdims=True)
    ng = ng / np.maximum(ng_len, 1e-30)

    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    d = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    # degenerate-UV clamp (scene.c:128-135): |d| < 1e-4 snaps to +/-1e-4
    small = np.abs(d) < 1e-4
    d = np.where(small, np.where(d < 0, -1e-4, 1e-4), d)
    inv_d = (1.0 / d)[:, None]

    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_d
    bitangent = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv_d

    def _norm(v):
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1e-30)

    return (
        ng.astype(np.float32),
        _norm(tangent).astype(np.float32),
        _norm(bitangent).astype(np.float32),
    )


def _vec3_planes(a: np.ndarray) -> Vec3:
    """(N, 3) numpy -> Vec3 of (N,) device planes."""
    return Vec3(
        x=jnp.asarray(np.ascontiguousarray(a[:, 0])),
        y=jnp.asarray(np.ascontiguousarray(a[:, 1])),
        z=jnp.asarray(np.ascontiguousarray(a[:, 2])),
    )


def pack_triangles(mesh: HostMesh, slot_map: np.ndarray) -> Triangles:
    """Pack host triangles into the device SoA layout according to the BVH
    build's leaf-slot assignment (-1 = empty padding slot -> all-zero)."""
    capacity = len(slot_map)
    assert capacity % BVH_WIDTH == 0
    valid = slot_map >= 0
    idx = np.where(valid, slot_map, 0)

    def place(a: np.ndarray) -> np.ndarray:
        out = a[idx]
        out[~valid] = 0
        return out

    pos = place(mesh.positions.astype(np.float32))
    nrm = place(mesh.normals.astype(np.float32))
    uv = place(mesh.uvs.astype(np.float32))
    ng, tan, btn = compute_tangents(pos, uv)
    ng[~valid] = 0.0
    tan[~valid] = 0.0
    btn[~valid] = 0.0
    mat = mesh.mat_id.astype(np.int32)[idx]
    mat[~valid] = -1

    v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]

    # leaf block row table: (n_blocks, 128) with 9 groups of 8 lanes
    n_blocks = capacity // BVH_WIDTH
    comps = np.stack(
        [v0[:, 0], v0[:, 1], v0[:, 2],
         (v1 - v0)[:, 0], (v1 - v0)[:, 1], (v1 - v0)[:, 2],
         (v2 - v0)[:, 0], (v2 - v0)[:, 1], (v2 - v0)[:, 2]],
        axis=1,
    )  # (capacity, 9)
    rows = np.zeros((n_blocks, 128), np.float32)
    rows[:, : 9 * BVH_WIDTH] = (
        comps.reshape(n_blocks, BVH_WIDTH, 9).transpose(0, 2, 1).reshape(n_blocks, -1)
    )

    attr = np.zeros((capacity, 128), np.float32)
    attr[:, ATTR_N0:ATTR_N0 + 3] = nrm[:, 0]
    attr[:, ATTR_N1:ATTR_N1 + 3] = nrm[:, 1]
    attr[:, ATTR_N2:ATTR_N2 + 3] = nrm[:, 2]
    attr[:, ATTR_NG:ATTR_NG + 3] = ng
    attr[:, ATTR_TAN:ATTR_TAN + 3] = tan
    attr[:, ATTR_BTN:ATTR_BTN + 3] = btn
    attr[:, ATTR_UV:ATTR_UV + 6] = uv.reshape(capacity, 6)
    attr[:, ATTR_MAT] = mat.astype(np.float32)

    return Triangles(
        leaf_rows=jnp.asarray(rows),
        attr_rows=jnp.asarray(attr),
        v0=_vec3_planes(v0),
        e1=_vec3_planes(v1 - v0),
        e2=_vec3_planes(v2 - v0),
        n0=_vec3_planes(nrm[:, 0]),
        n1=_vec3_planes(nrm[:, 1]),
        n2=_vec3_planes(nrm[:, 2]),
        ng=_vec3_planes(ng),
        tangent=_vec3_planes(tan),
        bitangent=_vec3_planes(btn),
        uv0u=jnp.asarray(np.ascontiguousarray(uv[:, 0, 0])),
        uv0v=jnp.asarray(np.ascontiguousarray(uv[:, 0, 1])),
        uv1u=jnp.asarray(np.ascontiguousarray(uv[:, 1, 0])),
        uv1v=jnp.asarray(np.ascontiguousarray(uv[:, 1, 1])),
        uv2u=jnp.asarray(np.ascontiguousarray(uv[:, 2, 0])),
        uv2v=jnp.asarray(np.ascontiguousarray(uv[:, 2, 1])),
        mat_id=jnp.asarray(mat),
    )


def build_scene(
    mesh: HostMesh,
    materials: "MaterialTable",
    atlas: "TextureAtlas",
    background: "Background",
    camera: "Camera",
    spheres: "Spheres | None" = None,
) -> "Scene":
    """scene_init (scene.c:416-426): build the BVH and pack the SoA store."""
    from raytracing_jax.models.bvh import build_bvh

    bvh, slot_map, _capacity = build_bvh(mesh)
    triangles = pack_triangles(mesh, slot_map)
    env = None
    if background.kind == BG_EQUIRECT and int(background.tex_id) >= 0:
        from raytracing_jax.ops.env_light import build_env_light

        env = build_env_light(atlas, int(background.tex_id))
    return Scene(
        triangles=triangles,
        bvh=bvh,
        materials=materials,
        atlas=atlas,
        spheres=spheres if spheres is not None else Spheres.empty(),
        background=background,
        camera=camera,
        n_triangles=int(mesh.positions.shape[0]),
        env_light=env,
    )
