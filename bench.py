"""Headline benchmark: Mrays/s on helmet.glb at 1080p (BASELINE.json).

Prints ONE JSON line: {"metric", "value", "unit"}. Rays are counted the
honest way: every scene intersection actually executed (samples x bounces
taken, including backface re-casts) — see BASELINE.md's measurement note.

Timer discipline (mirrors the reference's bracket, driver.c:791-825):
- the warmup compiles the EXACT program the timed loop runs — same
  k_group, same batch_px, same full-image pixel-table shape (a warmup of
  another k_group would put a compile inside the timed region);
- jax_log_compiles is monitored during the timed region; if any compile
  fires anyway, the timed run is re-executed once (now warm) and the
  event is reported on stderr;
- stderr additionally reports device-only throughput (`device_mrays=`):
  rays over the device's busy time in a profiled warm render, where busy
  time is the union of the intervals of all operations on the GPU
  device planes of the trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import jax

from raytracing_jax.utils import compile_cache

HELMET = "/root/reference/models/helmet.glb"
WIDTH, HEIGHT = 1920, 1080
SPP = 16
BOUNCES = 8
# x16 spp = 1M rays per device program (bucket-compacted); the env
# overrides exist for sweep A/Bs only — the defaults ARE the bench contract
BATCH_PIXELS = int(os.environ.get("RAYTPU_BENCH_BATCH_PX", 65536))
K_GROUP = int(os.environ.get("RAYTPU_BENCH_KGROUP", 4))


class _CompileCounter(logging.Handler):
    """Counts 'Finished XLA compilation' records (jax_log_compiles emits
    them at WARNING on logger jax._src.interpreters.pxla)."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.count = 0

    def emit(self, record):
        if "compilation" in record.getMessage():
            self.count += 1


def _busy_seconds(events, device_pids) -> float:
    """Union of the [ts, ts + dur) intervals of the device planes' events,
    in seconds (nested and overlapping spans count once)."""
    spans = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0))
        for e in events
        if e.get("ph") == "X" and e.get("pid") in device_pids
    )
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def _device_seconds_of(fn):
    """Run fn() under jax.profiler.trace and return the GPU devices' busy
    seconds, read from the Chrome trace the profiler writes."""
    out_dir = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with jax.profiler.trace(out_dir):
            fn()
        traces = glob.glob(f"{out_dir}/**/*.trace.json.gz", recursive=True)
        if not traces:
            raise RuntimeError(f"the profiler wrote no trace under {out_dir}")
        with gzip.open(traces[0]) as f:
            evs = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    device_pids = {
        e["pid"]
        for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and e["args"].get("name", "").startswith("/device:GPU")
    }
    if not device_pids:
        raise RuntimeError("the trace has no GPU device plane")
    return _busy_seconds(evs, device_pids)


def main() -> int:
    from raytracing_jax.io.loader import load_scene
    from raytracing_jax.render.renderer import render

    compile_cache.enable()

    scene = load_scene(HELMET, background_path=None, warn=lambda *a: None)

    kw = dict(
        spp=SPP, max_bounces=BOUNCES, batch_pixels=BATCH_PIXELS,
        k_group=K_GROUP,
    )

    # warmup: ONE grouped dispatch of the identical static program
    # (limit_batches=K_GROUP keeps k_group=min(K_GROUP, n_batches)=K_GROUP
    # and the full-size pixel table is uploaded either way)
    render(scene, WIDTH, HEIGHT, seed=1, limit_batches=K_GROUP, **kw)

    counter = _CompileCounter()
    logging.getLogger("jax").addHandler(counter)
    jax.config.update("jax_log_compiles", True)
    compiles_in_timed = 0
    try:
        for attempt in range(2):
            n0 = counter.count
            t0 = time.perf_counter()
            img, stats = render(scene, WIDTH, HEIGHT, seed=0, **kw)
            wall = time.perf_counter() - t0
            compiles_in_timed = counter.count - n0
            if compiles_in_timed == 0:
                break
            print(
                f"# WARNING: {compiles_in_timed} compile(s) fired inside the "
                f"timed region (attempt {attempt}); re-running warm",
                file=sys.stderr,
            )
    finally:
        jax.config.update("jax_log_compiles", False)
        logging.getLogger("jax").removeHandler(counter)

    mrays = stats.rays_traced / 1e6 / wall
    result = {
        "metric": "helmet.glb 1080p Mrays/s (1 chip)",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
    }
    print(json.dumps(result))

    # device-only throughput: profile a warm FULL-frame render (the first
    # tile-ordered batches alone are sky tiles — unrepresentative)
    rays_box = {}

    def full_frame():
        _, s = render(scene, WIDTH, HEIGHT, seed=2, **kw)
        rays_box["rays"] = s.rays_traced

    device_mrays = rays_box["rays"] / 1e6 / _device_seconds_of(full_frame)

    print(
        f"# wall={wall:.2f}s rays={stats.rays_traced:.3e} "
        f"samples={stats.samples:.3e} samples/s={stats.samples / wall:.3e} "
        f"compiles_in_timed={compiles_in_timed} "
        f"device_mrays={device_mrays:.2f} "
        f"device={jax.devices()[0]}",
        file=sys.stderr,
    )
    from raytracing_jax.io.image_io import write_png

    write_png(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_helmet_1080p.png"), img)

    # secondary anti-overfit metric: tower.obj (BASELINE config 5, the
    # numerics canary — high-poly sliver geometry, env-lit). Helmet-specific
    # tuning (k_group, bucket ladder) must not regress it. stderr only; the
    # contract stays ONE stdout JSON line.
    tower = load_scene("/root/reference/models/tower.obj",
                       background_path=None, warn=lambda *a: None)
    tkw = dict(spp=SPP, max_bounces=BOUNCES,
               batch_pixels=BATCH_PIXELS, k_group=K_GROUP)
    render(tower, 1024, 1024, seed=1, limit_batches=K_GROUP, **tkw)
    t0 = time.perf_counter()
    _, tstats = render(tower, 1024, 1024, seed=0, **tkw)
    twall = time.perf_counter() - t0
    print(
        f"# secondary: tower.obj 1024x1024x{SPP}spp "
        f"{tstats.rays_traced / 1e6 / twall:.3f} Mrays/s "
        f"(wall={twall:.2f}s rays={tstats.rays_traced:.3e})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
