"""Golden-image regression tests — the five BASELINE.json configs + sheen.

SURVEY §4 / BASELINE.md: golden renders at fixed seeds with PSNR thresholds
gate every change (the reference's checked-in output.png/tower.png
discipline). The configs cover the full feature surface: quad (hit/UV
sanity), fov_test (camera/FOV), spheres (metallic-roughness sweep), helmet
(textured glTF PBR + denoiser), tower (env-lit path trace + denoiser),
sheen (the KHR_materials_sheen lobe — /root/reference/models/sheen.glb,
the reference's sixth graduated test scene).

Goldens are rendered on the CPU backend at 256px with low spp to bound
suite time.
"""

import os

import numpy as np
import pytest

from raytracing_jax.io.loader import load_scene
from raytracing_jax.render.renderer import render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MODELS = "/root/reference/models"


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return np.inf
    return 10.0 * np.log10(255.0**2 / mse)


def _render_case(model: str, size: int, spp: int, bounces: int,
                 denoise: bool = False, seed: int = 42):
    scene = load_scene(
        f"{MODELS}/{model}", background_path=None, warn=lambda *a: None
    )
    img, _ = render(
        scene, size, size, spp=spp, max_bounces=bounces, seed=seed
    )
    if denoise:
        from raytracing_jax.ops.denoise import denoise_u8

        img = np.asarray(denoise_u8(img))
    return img


# name -> (model, size, spp, bounces, denoise) — BASELINE.md configs 1-5
# + the sheen-lobe scene (SURVEY §4)
CASES = {
    "quad": ("quad.obj", 256, 2, 2, False),
    "fov_test": ("fov_test.obj", 256, 2, 3, False),
    "spheres": ("spheres.glb", 256, 2, 3, False),
    "helmet": ("helmet.glb", 256, 2, 2, True),
    "tower": ("tower.obj", 256, 2, 3, True),
    "sheen": ("sheen.glb", 256, 2, 3, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    img = _render_case(*CASES[name])
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    if not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.save(path, img)
        pytest.skip(f"golden {name} created; rerun to compare")
    golden = np.load(path)
    p = psnr(img, golden)
    # identical seeds/algorithm should be bit-exact on one platform; allow
    # cross-backend drift down to 45 dB
    assert p >= 45.0, f"PSNR {p:.1f} dB vs golden {name}"


def test_accumulate_matches_drain():
    """The device-resident accumulator path (single final readback,
    renderer.render_batches_grouped_acc) must assemble the EXACT image the
    per-group draining path does — same batches, same program, different
    host plumbing. Small batch_pixels forces multiple k_groups plus a
    clamped partial tail group."""
    scene = load_scene(
        f"{MODELS}/fov_test.obj", background_path=None, warn=lambda *a: None
    )
    kw = dict(spp=2, max_bounces=2, seed=7, batch_pixels=2048)
    img_acc, st_acc = render(scene, 96, 96, accumulate=True, **kw)
    img_drn, st_drn = render(scene, 96, 96, accumulate=False, **kw)
    assert st_acc.batches == 5  # multi-group + partial tail
    assert (img_acc == img_drn).all()
    assert st_acc.rays_traced == st_drn.rays_traced


def test_fov_test_structure():
    """fov_test is the camera/FOV validation scene (SURVEY §4): the cube
    staircase covers the center; the top-left corner is open sky."""
    img = _render_case("fov_test.obj", 64, 2, 2).astype(np.float64)
    sky = img[0, 0]  # top-left corner is sky (verified via the hit mask)
    # sky pixels are exactly the constant background -> zero variance there
    assert (img[0, :2] == sky).all() and (img[1, :2] == sky).all()
    # geometry covers the image center and is darker than the sky
    assert img[32, 28:36].sum() < sky.sum() * 8
