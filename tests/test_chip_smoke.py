"""chip_smoke.py and its seeded helmet-scale scene, on the CPU: the scene
is deterministic and at helmet scale, and the script refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from raytracing_jax.models import synthetic
from raytracing_jax.models.scene import BG_EQUIRECT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host(seed, tex=64):
    return synthetic.helmet_like_host(seed, tex_size=tex, env_size=(64, 32))


def test_scene_is_deterministic_per_seed():
    a, b, c = _host(3), _host(3), _host(4)
    np.testing.assert_array_equal(a[0].positions, b[0].positions)
    np.testing.assert_array_equal(a[0].uvs, b[0].uvs)
    for ia, ib in zip(a[2]._images, b[2]._images):
        np.testing.assert_array_equal(ia, ib)
    assert not np.array_equal(a[0].positions, c[0].positions)


def test_scene_has_helmet_shapes():
    mesh, mats, atlas, env, camera = synthetic.helmet_like_host(0)
    assert mesh.positions.shape == (15_452, 3, 3)
    assert synthetic.N_TRIANGLES == 15_452
    # four 2048^2 RGB textures plus the equirect environment map
    sizes = [im.shape for im in atlas._images[1:]]
    assert sizes[:4] == [(2048, 2048, 3)] * 4
    assert sizes[4] == (512, 1024, 3) and env == 5
    assert len(mats) >= 4
    assert any(max(m.emission) > 0 for m in mats)  # an emissive material
    used = set(np.unique(mesh.mat_id))
    assert used == set(range(len(mats)))
    assert all(m.tex_albedo >= 0 or m.tex_emission >= 0 or
               m.tex_normal >= 0 for m in mats)
    assert np.isfinite(mesh.uvs).all() and np.isfinite(mesh.normals).all()


def test_built_scene_has_tangents_and_env_light():
    scene = synthetic.helmet_like(1, tex_size=64, env_size=(64, 32))
    assert scene.n_triangles == synthetic.N_TRIANGLES
    assert scene.background.kind == BG_EQUIRECT
    assert scene.env_light is not None
    tan = np.stack([np.asarray(c) for c in (scene.triangles.tangent.x,
                                             scene.triangles.tangent.y,
                                             scene.triangles.tangent.z)], 1)
    live = np.asarray(scene.triangles.mat_id) >= 0
    np.testing.assert_allclose(np.linalg.norm(tan[live], axis=1), 1.0,
                               atol=1e-4)


def _run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    r = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


@pytest.mark.parametrize("platforms", ["cpu", ""])
def test_exits_nonzero_alone_in_a_directory(tmp_path, platforms):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), {"JAX_PLATFORMS": platforms,
                             "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
