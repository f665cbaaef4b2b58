"""Traversal A/B on one device: the stack kernel against XLA `topk` and `dfs`.

Per-intersect times at 262,144 rays on camera rays and on bounce-1 rays of
the seeded helmet-scale scene (models/synthetic.py), hit agreement with the
brute-force oracle, and optionally whole warm renders at 1920x1080 x 16 spp
x 8 bounces. Everything runs in one process, so all numbers share one card.

    python tools/traverse_ab.py [--render] [--out chiprun_out/traverse_ab.json]

Prints one line per measurement and writes them all as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracing_jax.models import synthetic  # noqa: E402
from raytracing_jax.ops import hitcheck, traverse, traverse_stack  # noqa: E402
from raytracing_jax.render.renderer import render  # noqa: E402


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except OSError as e:
        return f"nvidia-smi unavailable ({e})"


def time_fn(fn, reps):
    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), ts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=262_144)
    ap.add_argument("--check-rays", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--configs", default="64x2,32x1,128x4")
    ap.add_argument("--interpret", action="store_true",
                    help="run the kernel in interpret mode (CPU rehearsal)")
    ap.add_argument("--out", default="chiprun_out/traverse_ab.json")
    a = ap.parse_args(argv)

    dev = jax.devices()[0]
    res = {"card": card(), "platform": dev.platform,
           "device_kind": dev.device_kind, "runs": []}
    print("card:", res["card"], dev.platform, dev.device_kind, flush=True)

    def log(**kw):
        res["runs"].append(kw)
        print(json.dumps(kw), flush=True)

    t0 = time.perf_counter()
    scene = synthetic.helmet_like(0)
    log(phase="scene", seconds=time.perf_counter() - t0,
        triangles=scene.n_triangles, depth=scene.bvh.depth)

    configs = [tuple(int(x) for x in c.split("x"))
               for c in a.configs.split(",")]
    tr, bvh = scene.triangles, scene.bvh

    def stack_fn(block, warps):
        return lambda o, d, act: traverse_stack.intersect_bvh_stack(
            o, d, tr, bvh, act, block=block, num_warps=warps,
            interpret=a.interpret)

    methods = {f"stack_{b}x{w}": stack_fn(b, w) for b, w in configs}
    methods["topk"] = jax.jit(
        lambda o, d, act: traverse.intersect_bvh_verified(o, d, tr, bvh, act))
    methods["dfs"] = jax.jit(
        lambda o, d, act: traverse.intersect_bvh(o, d, tr, bvh, act))

    # correctness at check size, camera and bounce rays
    def ray_sets(n, seed):
        o, d = hitcheck.camera_rays(scene, n, synthetic.WIDTH,
                                    synthetic.HEIGHT, seed)
        act = jnp.ones((n,), bool)
        hit = first(o, d, act)
        return {"camera": (o, d, act),
                "bounce": hitcheck.bounce_rays(scene, o, d, hit, seed + 1)}

    first = methods[f"stack_{configs[0][0]}x{configs[0][1]}"]
    for kind, (ro, rd, ra) in ray_sets(a.check_rays, 1).items():
        want = hitcheck.bruteforce(tr, ro, rd, ra)
        for name in [m for m in methods if m.startswith("stack")] + ["topk"]:
            log(phase="check", rays_kind=kind, method=name,
                **hitcheck.compare(methods[name](ro, rd, ra), want, tr, ro,
                                   rd))

    # per-intersect times at the timing size
    n = a.rays
    for kind, (ro, rd, ra) in ray_sets(n, 3).items():
        for name, fn in methods.items():
            reps = 2 if name == "dfs" else a.reps
            med, ts = time_fn(lambda: fn(ro, rd, ra), reps)
            log(phase="intersect", rays_kind=kind, method=name, rays=n,
                live=int(np.asarray(ra).sum()), ms_median=med, ms_all=ts)

    if a.render:
        kw = dict(spp=16, max_bounces=8)
        for name in ("stack", "topk"):
            t0 = time.perf_counter()
            render(scene, 1920, 1080, seed=1, limit_batches=4, method=name,
                   **kw)
            compile_s = time.perf_counter() - t0
            img, st = render(scene, 1920, 1080, seed=0, method=name, **kw)
            log(phase="render", method=name, wall_ms=st.wall_ms,
                rays=st.rays_traced, mrays=st.mrays_per_sec,
                warmup_s=compile_s, mean=float(img.mean()),
                peak_bytes=dev.memory_stats().get("peak_bytes_in_use"))
        from raytracing_jax.ops.denoise import denoise_u8

        med, ts = time_fn(lambda: denoise_u8(img), a.reps)
        log(phase="denoise", shape=list(img.shape), ms_median=med,
            ms_all=ts)

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
