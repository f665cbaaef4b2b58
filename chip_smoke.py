"""End-to-end check of the renderer on one GPU, through its user entry points.

    python3 chip_smoke.py [--seed N]    # one card: phases 1-5 below
    python3 chip_smoke.py --four        # four cards: the sharded render only

Phases, each printing its own lines:

1. the card's name and power limit (nvidia-smi, in a child process that
   does not start JAX);
2. the stack traversal kernel against `intersect_bruteforce` on 65,536
   camera rays and 65,536 bounce rays of the seeded helmet-scale scene
   (models/synthetic.py), and `onehot.fetch_rows_exact` against a plain
   gather, bit for bit;
3. a warm `render()` at 1920x1080, 16 spp, 8 bounces with method="auto",
   compared with the same-seed render by method="topk" (PSNR >= 45 dB);
4. the CLI in-process on the scene cache written in phase 2, with -D;
5. the last line: {"ok": true, "device": {...}} as JAX reports the device.

`--four` renders the same frame with `render(mesh=...)` over four cards,
compact=True and compact=False, against the one-card render: the dense
image must be identical and the compacted mean within 5%.

Exits non-zero, printing no result line, when the first JAX device is not
a GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 8
CHECK_RAYS = 65_536
MIN_PSNR_DB = 45.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def phase_kernel(scene, seed: int) -> None:
    """Phase 2: the kernel at real widths against the plain references."""
    import jax
    import jax.numpy as jnp

    from raytracing_jax.models import synthetic
    from raytracing_jax.ops import hitcheck, onehot
    from raytracing_jax.ops.traverse_stack import intersect_bvh_stack

    tris, bvh = scene.triangles, scene.bvh
    o, d = hitcheck.camera_rays(scene, CHECK_RAYS, synthetic.WIDTH,
                                synthetic.HEIGHT, seed)
    act = jnp.ones((CHECK_RAYS,), bool)
    cam = intersect_bvh_stack(o, d, tris, bvh, act)
    sets = {"camera": (o, d, act, cam)}
    bo, bd, bact = hitcheck.bounce_rays(scene, o, d, cam, seed + 1)
    sets["bounce"] = (bo, bd, bact, intersect_bvh_stack(bo, bd, tris, bvh,
                                                        bact))
    for kind, (ro, rd, ra, got) in sets.items():
        want = hitcheck.bruteforce(tris, ro, rd, ra)
        c = hitcheck.compare(got, want, tris, ro, rd)
        print(f"kernel vs intersect_bruteforce, {kind} rays: "
              + json.dumps(c), flush=True)
        check(c["hits"] > 0, f"{kind} rays hit nothing")
        for k in ("tri_mismatch", "t_mismatch", "uv_mismatch"):
            check(c[k] == 0, f"{kind} rays: {k} = {c[k]}")

    rng = np.random.default_rng(seed)
    tables = {
        "materials": np.asarray(scene.materials.rows).T,
        "random": rng.normal(0, 1e3, (16, 300)).astype(np.float32),
    }
    for name, table in tables.items():
        ids = jnp.asarray(rng.integers(0, table.shape[1], CHECK_RAYS,
                                       dtype=np.int32))
        t = jnp.asarray(table)
        got = np.asarray(jax.jit(onehot.fetch_rows_exact)(t, ids))
        want = np.asarray(jax.jit(lambda t, i: t[:, i])(t, ids))
        same = got.view(np.uint32) == want.view(np.uint32)
        print(f"onehot.fetch_rows_exact vs gather, {name} table "
              f"{table.shape}: {int((~same).sum())} of {same.size} words "
              "differ", flush=True)
        check(same.all(), f"fetch_rows_exact not bit-exact ({name})")


def phase_render(scene, dev) -> np.ndarray:
    """Phase 3: warm render() with method="auto" against method="topk"."""
    from raytracing_jax.render.renderer import auto_method, render

    method = auto_method(scene, dev.platform)
    kw = dict(spp=SPP, max_bounces=BOUNCES, seed=0)
    t0 = time.perf_counter()
    render(scene, WIDTH, HEIGHT, **{**kw, "seed": 1}, limit_batches=4)
    warm_s = time.perf_counter() - t0
    img, st = render(scene, WIDTH, HEIGHT, **kw)
    peak = dev.memory_stats().get("peak_bytes_in_use", 0)
    print(f"render {WIDTH}x{HEIGHT} {SPP}spp {BOUNCES} bounces, "
          f"method=auto -> {method}: {st.mrays_per_sec:.3f} Mrays/s, "
          f"wall {st.wall_ms:.1f} ms, {st.rays_traced} rays, peak device "
          f"memory {peak / 2**30:.2f} GiB (warm-up with compile "
          f"{warm_s:.1f} s)", flush=True)
    check(img.shape == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(img.std() > 5.0, f"flat image (std {img.std():.2f})")
    check(st.rays_traced > WIDTH * HEIGHT * SPP, "too few rays traced")

    t0 = time.perf_counter()
    ref, st_ref = render(scene, WIDTH, HEIGHT, method="topk", **kw)
    same = float((img == ref).all(axis=2).mean())
    db = psnr(img, ref)
    print(f"same-seed render by method=topk ({st_ref.mrays_per_sec:.3f} "
          f"Mrays/s cold, {time.perf_counter() - t0:.1f} s with compile): "
          f"{same * 100:.3f}% identical pixels, PSNR {db:.2f} dB",
          flush=True)
    check(db >= MIN_PSNR_DB, f"PSNR {db:.2f} dB < {MIN_PSNR_DB}")
    return img


def phase_cli(cache_path: str, out_dir: str) -> None:
    """Phase 4: the CLI, in this process, with the denoiser."""
    from raytracing_jax import cli
    from raytracing_jax.io.image_io import load_image_rgb_u8

    out = os.path.join(out_dir, "cli.png")
    argv = ["--load-scene", cache_path, "-W", str(WIDTH), "-H", str(HEIGHT),
            "-S", str(SPP), "-B", str(BOUNCES), "-D", "-V", "-O", out]
    print("cli:", " ".join(argv), flush=True)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    check(rc == 0, f"cli.main returned {rc}")
    img = load_image_rgb_u8(out)
    print(f"cli output {img.shape} decoded, mean {img.mean():.2f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(img.shape == (HEIGHT, WIDTH, 3), f"cli image shape {img.shape}")
    check(img.std() > 5.0, "cli image is flat")


def phase_four(scene) -> None:
    """--four: render(mesh=...) over four cards against one card."""
    import jax

    from raytracing_jax.parallel.mesh import make_mesh
    from raytracing_jax.render.renderer import render

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices < 4")
    mesh = make_mesh(jax.devices()[:4])
    kw = dict(spp=SPP, max_bounces=BOUNCES, seed=5)
    t0 = time.perf_counter()
    dense4, st4 = render(scene, WIDTH, HEIGHT, mesh=mesh, compact=False,
                         **kw)
    comp4, stc = render(scene, WIDTH, HEIGHT, mesh=mesh, compact=True, **kw)
    dense1, st1 = render(scene, WIDTH, HEIGHT, compact=False, **kw)
    comp1, _ = render(scene, WIDTH, HEIGHT, compact=True, **kw)
    a = comp4.astype(np.float64).mean()
    b = dense1.astype(np.float64).mean()
    same = float((dense4 == dense1).all(axis=2).mean())
    same_c = float((comp4 == comp1).all(axis=2).mean())
    print(f"four cards, {WIDTH}x{HEIGHT} {SPP}spp {BOUNCES} bounces: dense "
          f"sharded {st4.rays_traced} rays, {same * 100:.3f}% of pixels "
          f"identical to one card; compacted sharded {same_c * 100:.3f}% "
          f"identical to one card's compacted render, mean {a:.3f} vs dense "
          f"{b:.3f} ({abs(a - b) / b * 100:.2f}%); cold wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(same == 1.0, "dense sharded image differs from one card")
    check(st4.rays_traced == st1.rays_traced, "ray counts differ")
    check(abs(a - b) <= 0.05 * b, "compacted sharded mean off by > 5%")
    check(stc.rays_traced > WIDTH * HEIGHT * SPP, "too few compacted rays")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="only the four-card sharded render")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: the first JAX device is {dev.platform!r}, not a "
              "GPU; nothing was run", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracing_jax.models import serialization, synthetic
    from raytracing_jax.utils import compile_cache

    print("compile cache:", compile_cache.enable(), flush=True)
    print("card:", card_line(), flush=True)  # phase 1
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)

    t0 = time.perf_counter()
    scene = synthetic.helmet_like(args.seed)
    print(f"scene: {scene.n_triangles} triangles, BVH depth "
          f"{scene.bvh.depth}, {int(scene.atlas.tex_r.shape[0])} texels, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    if args.four:
        phase_four(scene)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cache = os.path.join(tmp, "scene.npz")
            serialization.save_scene_cache(cache, scene)
            phase_kernel(scene, args.seed)
            phase_render(scene, dev)
            phase_cli(cache, tmp)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
