"""Host-side material + texture staging.

Loaders produce a list of `HostMaterial` plus an `AtlasBuilder`; these are
packed into the device `MaterialTable` / `TextureAtlas`, which replace the
reference's per-material `PBR_Shader_Data` structs with raw image pointers
(driver.c:191-198).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from raytracing_jax.models.scene import (
    SHADER_DISNEY,
    MaterialTable,
    TextureAtlas,
)
from raytracing_jax.utils.vec3 import Vec3


class AtlasBuilder:
    """Packs decoded u8 RGB images into one flat texel array.

    Index 0 is reserved for the 1x1 white dummy (out-of-band "no texture").
    """

    def __init__(self) -> None:
        self._images: list[np.ndarray] = [np.full((1, 1, 3), 255, np.uint8)]
        self._dedup: dict = {}

    def add(self, img: np.ndarray, key=None) -> int:
        """Add an (H, W, 3) u8 image; returns its texture id. `key` enables
        dedup (the reference dedups OBJ textures by path hash map,
        driver.c:518-527)."""
        if key is not None and key in self._dedup:
            return self._dedup[key]
        assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
        tid = len(self._images)
        self._images.append(np.ascontiguousarray(img))
        if key is not None:
            self._dedup[key] = tid
        return tid

    def build(self) -> TextureAtlas:
        offsets, widths, heights = [], [], []
        off = 0
        flats = []
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            flats.append(img.reshape(-1, 3))
            off += w * h
        texels = np.concatenate(flats, axis=0)
        return TextureAtlas(
            tex_r=jnp.asarray(np.ascontiguousarray(texels[:, 0])),
            tex_g=jnp.asarray(np.ascontiguousarray(texels[:, 1])),
            tex_b=jnp.asarray(np.ascontiguousarray(texels[:, 2])),
            offset=jnp.asarray(np.array(offsets, np.int32)),
            width=jnp.asarray(np.array(widths, np.int32)),
            height=jnp.asarray(np.array(heights, np.int32)),
        ).with_pages()


@dataclass
class HostMaterial:
    """One material row (reference PBR_Shader_Data, driver.c:191-198)."""

    base_color: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5  # reference OBJ default, driver.c:553
    metalness: float = 0.0
    normal_strength: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    anisotropic: float = 0.0
    tex_albedo: int = -1
    tex_normal: int = -1
    tex_mr: int = -1
    tex_emission: int = -1
    shader_kind: int = SHADER_DISNEY
    name: str = ""
    extra: dict = field(default_factory=dict)


def build_material_table(mats: list[HostMaterial]) -> MaterialTable:
    if not mats:
        mats = [HostMaterial()]
    f32 = np.float32

    def vec(field):
        a = np.array([getattr(m, field) for m in mats], f32)
        return Vec3(
            x=jnp.asarray(np.ascontiguousarray(a[:, 0])),
            y=jnp.asarray(np.ascontiguousarray(a[:, 1])),
            z=jnp.asarray(np.ascontiguousarray(a[:, 2])),
        )

    return MaterialTable(
        base_color=vec("base_color"),
        emission=vec("emission"),
        roughness=jnp.asarray(np.array([m.roughness for m in mats], f32)),
        metalness=jnp.asarray(np.array([m.metalness for m in mats], f32)),
        normal_strength=jnp.asarray(
            np.array([m.normal_strength for m in mats], f32)
        ),
        sheen=jnp.asarray(np.array([m.sheen for m in mats], f32)),
        sheen_tint=jnp.asarray(np.array([m.sheen_tint for m in mats], f32)),
        anisotropic=jnp.asarray(np.array([m.anisotropic for m in mats], f32)),
        tex_albedo=jnp.asarray(np.array([m.tex_albedo for m in mats], np.int32)),
        tex_normal=jnp.asarray(np.array([m.tex_normal for m in mats], np.int32)),
        tex_mr=jnp.asarray(np.array([m.tex_mr for m in mats], np.int32)),
        tex_emission=jnp.asarray(
            np.array([m.tex_emission for m in mats], np.int32)
        ),
        shader_kind=jnp.asarray(
            np.array([m.shader_kind for m in mats], np.int32)
        ),
    ).with_rows()
