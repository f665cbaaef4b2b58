"""Command-line renderer.

Flag surface mirrors the reference driver (driver.c:420-508):
  -W width -H height -S samples -T threads -B max_bounces -V -D
  -O output.(png|qoi|ppm) model.(obj|glb|gltf)
defaults 1024x1024, 16 spp, 8 bounces, output.png (driver.c:733-742).

Extra (new-framework) flags are double-dashed: --seed, --bg, --no-bg,
--batch-pixels, --brute-force, --debug-normals, --tonemap, --save-scene,
--load-scene, --profile, --nearest (the reference's compile-time texture
filter switch, driver.c:13-14, as a runtime flag), --rr (Russian-roulette
path termination from bounce 3), --nee (environment-light next-event
estimation with MIS) — both beyond-parity, unbiased, default off.

-T is accepted for CLI parity; device execution replaces host threads (the
batch is one device program; use --batch-pixels to change batching).
"""

from __future__ import annotations

import sys
import time


def print_usage(prog: str) -> None:
    print(
        f"{prog} -W <width> -H <height> -S <samples> -T <threads> "
        "-B <max_bounces> <model.(obj|glb|gltf)> -O output.(qoi|png|ppm)",
        file=sys.stderr,
    )


def parse_args(argv: list[str]):
    cfg = {
        "width": 1024,
        "height": 1024,
        "samples": 16,
        "max_bounces": 8,
        "n_threads": 1,
        "verbose": False,
        "denoise": False,
        "output": "output.png",
        "model": None,
        "seed": 0,
        "background": "background.png",
        "batch_pixels": None,
        "brute_force": False,
        "debug_normals": False,
        "rr": False,
        "nee": False,
        "tonemap": None,
        "save_scene": None,
        "load_scene": None,
        "profile": None,
        "texture_mode": "bilinear",
        "method": None,  # --method: force a traversal method (default auto)
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-V":
            cfg["verbose"] = True
            i += 1
        elif a == "-D":
            cfg["denoise"] = True
            i += 1
        elif a in ("-W", "-H", "-S", "-T", "-B", "-O"):
            if i + 1 >= len(argv):
                return None
            v = argv[i + 1]
            key = {
                "-W": "width", "-H": "height", "-S": "samples",
                "-T": "n_threads", "-B": "max_bounces", "-O": "output",
            }[a]
            cfg[key] = v if a == "-O" else int(v)
            i += 2
        elif a == "--no-bg":
            cfg["background"] = None
            i += 1
        elif a in ("--seed", "--bg", "--batch-pixels", "--tonemap",
                   "--save-scene", "--load-scene", "--profile",
                   "--method"):
            if i + 1 >= len(argv):
                return None
            key = a[2:].replace("-", "_")
            if a == "--bg":
                key = "background"
            v = argv[i + 1]
            if a == "--method" and v not in (
                "auto", "stack", "topk", "dfs", "brute",
            ):
                print(f"unknown --method '{v}'", file=sys.stderr)
                return None
            if a == "--tonemap" and v not in ("aces", "reinhard"):
                return None
            cfg[key] = int(v) if a in ("--seed", "--batch-pixels") else v
            i += 2
        elif a == "--brute-force":
            cfg["brute_force"] = True
            i += 1
        elif a == "--nearest":
            cfg["texture_mode"] = "nearest"
            i += 1
        elif a == "--debug-normals":
            cfg["debug_normals"] = True
            i += 1
        elif a == "--rr":
            cfg["rr"] = True
            i += 1
        elif a == "--nee":
            cfg["nee"] = True
            i += 1
        elif a.startswith("-"):
            return None
        else:
            if cfg["model"] is not None:
                return None
            cfg["model"] = a
            i += 1
    if cfg["model"] is None and cfg["load_scene"] is None:
        return None
    return cfg


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_args(argv)
    if cfg is None:
        print_usage(sys.argv[0])
        return 1

    import jax
    import numpy as np

    from raytracing_jax.io.image_io import write_image
    from raytracing_jax.io.loader import load_scene
    from raytracing_jax.models import serialization
    from raytracing_jax.ops.denoise import denoise_u8
    from raytracing_jax.render.renderer import render
    from raytracing_jax.utils.progress import ProgressBar

    warn = print if cfg["verbose"] else (lambda *a, **k: None)

    t0 = time.perf_counter()
    if cfg["load_scene"]:
        scene = serialization.load_scene_cache(cfg["load_scene"])
    else:
        try:
            scene = load_scene(cfg["model"],
                               background_path=cfg["background"], warn=warn)
        except FileNotFoundError as e:
            # missing env map is fatal, matching the reference's
            # load_texture error surface (driver.c:106-116)
            print(e, file=sys.stderr)
            return 1
    bvh_ms = (time.perf_counter() - t0) * 1e3

    if cfg["debug_normals"]:
        import jax.numpy as jnp
        from raytracing_jax.models.scene import SHADER_DEBUG_NORMAL

        scene = scene.replace(
            materials=scene.materials.replace(
                shader_kind=jnp.full_like(
                    scene.materials.shader_kind, SHADER_DEBUG_NORMAL
                )
            ).with_rows()
        )

    if cfg["save_scene"]:
        serialization.save_scene_cache(cfg["save_scene"], scene)
        if cfg["verbose"]:
            print(f"scene cache written to {cfg['save_scene']}")

    if cfg["verbose"]:
        print(f"Bvh generated in {bvh_ms:.0f}ms")
        print(f"Width:     {cfg['width']}")
        print(f"Height:    {cfg['height']}")
        print(f"Samples:   {cfg['samples']}")
        print(f"Bounces:   {cfg['max_bounces']}")
        print(f"Threads:   {cfg['n_threads']} (ignored: device execution)")
        print(f"BVH-Nodes: {scene.bvh.n_internal}")
        print(f"BVH-Depth: {scene.bvh.depth}")
        print(f"Triangles: {scene.n_triangles}")
        print(f"Devices:   {jax.devices()}")
        print()

    if cfg["profile"]:
        jax.profiler.start_trace(cfg["profile"])

    bar = ProgressBar()
    img, stats = render(
        scene,
        cfg["width"],
        cfg["height"],
        spp=cfg["samples"],
        max_bounces=cfg["max_bounces"],
        seed=cfg["seed"],
        batch_pixels=cfg["batch_pixels"],
        method=(
            cfg.get("method")
            or ("brute" if cfg["brute_force"] else "auto")
        ),
        texture_mode=cfg["texture_mode"],
        progress=bar,
        rr=cfg["rr"],
        nee=cfg["nee"],
        tonemap=cfg["tonemap"],
    )
    bar.finish()

    if cfg["profile"]:
        jax.profiler.stop_trace()

    # --tonemap is applied on the FLOAT radiance inside the render
    # (renderer._batch_core), matching the reference's hook placement
    # before clamp+encode (raytracer.c:701) — not on quantized u8.
    print(f"{stats.wall_ms:.0f}ms")
    if cfg["verbose"]:
        print(f"{stats.samples_per_sec:.0f} samples/second")
        print(f"{stats.mrays_per_sec:.2f} Mrays/second "
              f"({stats.rays_traced} rays traced)")

    if cfg["denoise"]:
        t0 = time.perf_counter()
        img = np.asarray(denoise_u8(img))
        print(f"Denoising: {(time.perf_counter() - t0) * 1e3:.0f}ms")

    t0 = time.perf_counter()
    write_image(cfg["output"], img, warn=print)
    if cfg["verbose"]:
        print(f"Output file written in {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    from raytracing_jax.utils import compile_cache

    compile_cache.enable()
    raise SystemExit(main())
