"""Batched tile renderer.

The reference's thread/chunk execution model (render_thread_proc,
raytracer.c:596-720: 32x32 chunks pulled from an atomic counter by N threads)
becomes: the image is cut into flat pixel mega-batches; each batch renders as
ONE jitted device program over a ray arena of (pixels x spp) rays; batches
are optionally sharded across a `jax.sharding.Mesh` (chunks -> shards,
SURVEY §2.11). No atomics — accumulation is a reshape+mean per pixel.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_jax.render import camera as camera_mod
from raytracing_jax.render import integrator
from raytracing_jax.utils import color


@dataclass
class RenderStats:
    """Phase timers + throughput, mirroring the reference's -V metrics
    (driver.c:776-836): BVH build ms, render ms, samples/s — plus Mrays/s
    (BASELINE.md measurement note: rays = samples x bounces actually cast)."""

    wall_ms: float = 0.0
    samples: int = 0
    rays_traced: int = 0
    batches: int = 0
    compile_ms: float = 0.0
    extra: dict = field(default_factory=dict)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.wall_ms / 1e3, 1e-9)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / 1e6 / max(self.wall_ms / 1e3, 1e-9)


def _batch_core(scene, px, py, jitter, uniforms, nee_uniforms, key, *,
                width, height, spp, max_bounces, method, texture_mode,
                compact, rr, nee, tonemap=None, interpret=False):
    """Shared body of the batch renderers: raygen -> trace -> per-pixel
    spp mean. Dense trace consumes the pre-drawn `uniforms` stream; the
    bucketed tracer derives uniforms from (key, sample slot, bounce)
    instead, so its images are invariant to the compaction schedule."""
    p = px.shape[0]
    rpx = jnp.repeat(px, spp)
    rpy = jnp.repeat(py, spp)
    origin, direction = camera_mod.generate_rays(
        scene.camera, width, height, rpx, rpy, jitter[0], jitter[1]
    )

    if compact:
        radiance, rays = integrator.trace_bucketed(
            scene, origin, direction, key, max_bounces,
            method=method, texture_mode=texture_mode, rr=rr, nee=nee,
            interpret=interpret,
        )
    else:
        radiance, rays = integrator.trace(
            scene, origin, direction, uniforms, max_bounces,
            method=method, texture_mode=texture_mode, rr=rr, nee=nee,
            nee_uniforms=nee_uniforms, interpret=interpret,
        )
    rgb = jnp.stack(
        [
            radiance.x.reshape(p, spp).mean(axis=1),
            radiance.y.reshape(p, spp).mean(axis=1),
            radiance.z.reshape(p, spp).mean(axis=1),
        ],
        axis=-1,
    )
    # optional tonemap on the FLOAT per-pixel radiance — the reference's
    # (disabled) hook sits before the clamp+encode (raytracer.c:701), not
    # on quantized u8
    if tonemap == "aces":
        rgb = color.aces(rgb)
    elif tonemap == "reinhard":
        rgb = color.reinhard(rgb)
    # encode to u8 ON DEVICE: the per-batch readback drops from 12 B to
    # 3 B per pixel, and the per-pixel encode is identical to encoding the
    # assembled image
    return color.encode_u8(rgb), rays


def _draw_uniforms(key, r, max_bounces, nee, skip_mat=False):
    # stateless counter-based RNG replaces the reference's time-seeded
    # thread-local PCG (common.h:13-28, raytracer.c:597): one threefry draw
    # for raygen jitter + per-bounce material uniforms. All draws are
    # batch-minor: (2, R) and (bounces, 4, R).
    k_jit, k_mat = jax.random.split(key)
    jitter = jax.random.uniform(k_jit, (2, r), jnp.float32)
    uniforms = None if skip_mat else jax.random.uniform(
        k_mat, (max_bounces, 4, r), jnp.float32
    )
    nee_uniforms = None
    if nee and not skip_mat:
        # separate key so the base stream (and nee-off goldens) is unchanged
        k_nee = jax.random.fold_in(key, 7919)
        # 3 channels: (select+accept, jitter-x, jitter-y) for the env-CDF
        # alias sampler; the uniform-sphere fallback uses the first two
        nee_uniforms = jax.random.uniform(
            k_nee, (max_bounces, 3, r), jnp.float32
        )
    return jitter, uniforms, nee_uniforms


def _indexed_batch(scene, xs_all, ys_all, key, b, *, batch_px, spp,
                   max_bounces, compact, nee, **kw):
    """Batch b of the frame, fully device-side: the pixel list lives on
    device whole, and the batch slice and per-batch key fold happen inside
    the program, so the host hands over only the batch index. Indices past
    the last batch clamp to it (its pixels just re-render)."""
    b = jnp.minimum(b, jnp.uint32(xs_all.shape[0] // batch_px - 1))
    start = b * batch_px
    px = jax.lax.dynamic_slice_in_dim(xs_all, start, batch_px)
    py = jax.lax.dynamic_slice_in_dim(ys_all, start, batch_px)
    kb = jax.random.fold_in(key, b)
    jitter, uniforms, nee_uniforms = _draw_uniforms(
        kb, batch_px * spp, max_bounces, nee, skip_mat=compact
    )
    return _batch_core(
        scene, px, py, jitter, uniforms, nee_uniforms,
        jax.random.fold_in(kb, 1), spp=spp, max_bounces=max_bounces,
        compact=compact, nee=nee, **kw,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounces", "batch_px", "k_group",
        "method", "texture_mode", "compact", "rr", "nee", "tonemap",
        "interpret",
    ),
)
def render_batches_grouped(
    scene, xs_all, ys_all, key, b0, *, width: int, height: int, spp: int,
    max_bounces: int, batch_px: int, k_group: int, method: str = "topk",
    texture_mode: str = "bilinear", compact: bool = False,
    rr: bool = False, nee: bool = False, tonemap: str | None = None,
    interpret: bool = False,
):
    """k_group consecutive batches in ONE device program (lax.map over
    _indexed_batch), one dispatch per group. Returns (rgb_u8
    (k, batch_px, 3), rays (k,))."""

    def one(b):
        return _indexed_batch(
            scene, xs_all, ys_all, key, b, batch_px=batch_px, width=width,
            height=height, spp=spp, max_bounces=max_bounces, method=method,
            texture_mode=texture_mode, compact=compact, rr=rr, nee=nee,
            tonemap=tonemap, interpret=interpret,
        )

    return jax.lax.map(one, b0 + jnp.arange(k_group, dtype=jnp.uint32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounces", "batch_px", "k_group",
        "method", "texture_mode", "compact", "rr", "nee", "tonemap",
        "interpret",
    ),
    donate_argnums=(5, 6),
)
def render_batches_grouped_acc(
    scene, xs_all, ys_all, key, b0, acc, rays_acc, *, width: int,
    height: int, spp: int, max_bounces: int, batch_px: int, k_group: int,
    method: str = "topk", texture_mode: str = "bilinear",
    compact: bool = False, rr: bool = False, nee: bool = False,
    tonemap: str | None = None, interpret: bool = False,
):
    """render_batches_grouped, but the u8 pixels land in a DEVICE-resident
    accumulator instead of being read back per dispatch: acc
    ((n_groups*k_group*batch_px, 3) u8) and rays_acc ((n_groups*k_group,)
    f32) are donated, so XLA updates them in place, and the host fetches
    the whole image ONCE at the end of the render. rays_acc stays
    per-batch (each entry < 2^24 rays, exact in f32); the host reduces it
    in float64."""
    rgb, rays = render_batches_grouped(
        scene, xs_all, ys_all, key, b0, width=width, height=height,
        spp=spp, max_bounces=max_bounces, batch_px=batch_px,
        k_group=k_group, method=method, texture_mode=texture_mode,
        compact=compact, rr=rr, nee=nee, tonemap=tonemap,
        interpret=interpret,
    )
    acc = jax.lax.dynamic_update_slice_in_dim(
        acc, rgb.reshape(k_group * batch_px, 3),
        (b0 * batch_px).astype(jnp.int32), axis=0,
    )
    rays_acc = jax.lax.dynamic_update_slice_in_dim(
        rays_acc, rays, b0.astype(jnp.int32), axis=0
    )
    return acc, rays_acc


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounces", "method", "texture_mode",
        "compact", "rr", "nee", "tonemap", "interpret",
    ),
)
def render_batch(
    scene, px, py, key, *, width: int, height: int, spp: int,
    max_bounces: int, method: str = "topk", texture_mode: str = "bilinear",
    compact: bool = False, rr: bool = False, nee: bool = False,
    tonemap: str | None = None, interpret: bool = False,
):
    """Render one flat batch of pixels.

    px/py: (P,) i32 pixel coordinates. Returns (rgb_linear (P, 3) f32 mean
    over spp, rays_traced scalar).
    """
    jitter, uniforms, nee_uniforms = _draw_uniforms(
        key, px.shape[0] * spp, max_bounces, nee, skip_mat=compact
    )
    return _batch_core(
        scene, px, py, jitter, uniforms, nee_uniforms,
        jax.random.fold_in(key, 1),
        width=width, height=height, spp=spp, max_bounces=max_bounces,
        method=method, texture_mode=texture_mode, compact=compact, rr=rr,
        nee=nee, tonemap=tonemap, interpret=interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "spp", "max_bounces", "batch_px",
        "method", "texture_mode", "compact", "rr", "nee", "tonemap",
        "interpret",
    ),
)
def render_batch_sharded(
    scene, xs_all, ys_all, key, b0, *, mesh, width: int, height: int,
    spp: int, max_bounces: int, batch_px: int, method: str = "topk",
    texture_mode: str = "bilinear", compact: bool = False,
    rr: bool = False, nee: bool = False, tonemap: str | None = None,
    interpret: bool = False,
):
    """One batch per device of a 1-D mesh via shard_map (SURVEY §2: scene
    replicated, no collectives in the trace): device i renders batch b0 + i
    exactly as the single-device loop renders it — the same program shapes
    and the same per-batch RNG keys — so dense and compacted images alike
    equal the single-device render bit for bit, and each device's bucket
    compaction sorts only its own lanes. Returns (rgb_u8
    (n_dev, batch_px, 3), rays (n_dev,))."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def per_device(scene, xs_all, ys_all, key, b0):
        b = b0 + jax.lax.axis_index(axis).astype(jnp.uint32)
        rgb, rays = _indexed_batch(
            scene, xs_all, ys_all, key, b, batch_px=batch_px, width=width,
            height=height, spp=spp, max_bounces=max_bounces, method=method,
            texture_mode=texture_mode, compact=compact, rr=rr, nee=nee,
            tonemap=tonemap, interpret=interpret,
        )
        return rgb[None], rays[None]

    # check_vma off: zero-initialized loop carries start replicated and
    # become device-varying after one iteration, which the strict varying-
    # axis checker rejects; semantics are unaffected (a pure map)
    fn = jax.shard_map(
        per_device, mesh=mesh, in_specs=(P(),) * 5,
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    return fn(scene, xs_all, ys_all, key, b0)


@functools.lru_cache(maxsize=8)
def _pixel_tables(width: int, height: int, pad: int):
    """Tile-ordered pixel tables (the reference's 32x32 chunks,
    raytracer.c:601): batches then cover compact screen regions, so
    sky-only batches terminate after one bounce instead of dragging
    through the full loop. Cached per (width, height, pad) — rebuilding
    the lexsort and re-padding ~2M-entry tables costs tens of host ms per
    render call, all inside the timed region."""
    tile = 32
    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    order = np.lexsort((x % tile, y % tile, x // tile, y // tile))
    xs = x[order].astype(np.int32)
    ys = y[order].astype(np.int32)
    if pad:
        xs = np.concatenate([xs, np.zeros(pad, np.int32)])
        ys = np.concatenate([ys, np.zeros(pad, np.int32)])
    # out[perm[i]] is the pixel rendered at position i
    return xs, ys, order


@functools.lru_cache(maxsize=8)
def _pixel_tables_device(width: int, height: int, pad: int):
    """Device-resident copy of _pixel_tables' (xs, ys) — ONE upload per
    frame shape instead of one per render call."""
    xs, ys, _ = _pixel_tables(width, height, pad)
    return jnp.asarray(xs), jnp.asarray(ys)


#: traversal `auto` selects on each platform (traverse.intersect_scene)
AUTO_METHODS = {"gpu": "stack", "cpu": "topk"}


def auto_method(scene, platform: str) -> str:
    """method="auto": the brute-force oracle for scenes of <= 64 triangle
    slots (the reference's own `#if 0` path, raytracer.c:497-503), else the
    platform's traversal from AUTO_METHODS. Any other platform raises."""
    if scene.triangles.capacity <= 64:
        return "brute"
    if platform not in AUTO_METHODS:
        raise ValueError(
            f"no traversal method for platform '{platform}' "
            f"(known: {', '.join(AUTO_METHODS)})"
        )
    return AUTO_METHODS[platform]


def render(
    scene,
    width: int,
    height: int,
    spp: int = 16,
    max_bounces: int = 8,
    seed: int = 0,
    batch_pixels: int | None = None,
    method: str = "auto",
    mesh: "jax.sharding.Mesh | None" = None,
    progress=None,
    texture_mode: str = "bilinear",
    limit_batches: int | None = None,
    compact: bool | None = None,
    rr: bool = False,
    nee: bool = False,
    k_group: int | None = None,
    tonemap: str | None = None,
    accumulate: bool | None = None,
    interpret: bool = False,
):
    """Render a full image.

    Returns (image u8 (H, W, 3), RenderStats). method="auto" picks per
    platform (auto_method); "stack", "topk", "dfs" and "brute" force one
    (ops/traverse.py). interpret runs the "stack" kernel in Pallas
    interpret mode (tests). `mesh` renders one whole batch per device
    (render_batch_sharded: scene replicated; per SURVEY §2 the only
    cross-device traffic is the image readback), and the image equals the
    single-device render bit for bit.

    compact: on-device bucket compaction of the bounce loop
    (integrator.trace_bucketed). Default on. Mesh renders run it per
    device, on each device's own lanes.

    accumulate: keep the rendered u8 pixels in a device-resident donated
    buffer and read the whole image back ONCE at the end, instead of a
    per-group readback (render_batches_grouped_acc). Default (None): on
    when single-device and no progress callback; a progress callback needs
    per-batch completion, so it keeps the draining path.
    """
    if compact is None:
        compact = True
    if method == "auto":
        devices = mesh.devices.flat if mesh is not None else jax.devices()
        method = auto_method(scene, next(iter(devices)).platform)

    n_pixels = width * height
    if batch_pixels is None:
        # bound the live ray arena: top-k traversal materializes a few
        # (k_leaf*8, R) intermediates, so ~256k rays keeps them ~128 MB each
        batch_pixels = max(1, min(n_pixels, (262_144 // max(spp, 1))))

    # pad pixel count so every batch has identical shape (one compile)
    n_batches = (n_pixels + batch_pixels - 1) // batch_pixels
    # full-frame batch count BEFORE limit_batches: the accumulator buffer
    # is sized from it so a limit_batches warmup compiles the exact
    # program (same acc shape) the unlimited timed run uses
    n_batches_full = n_batches
    pad = n_batches * batch_pixels - n_pixels
    _, _, perm = _pixel_tables(width, height, pad)


    key = jax.random.PRNGKey(seed)
    out = np.zeros((n_pixels + pad, 3), np.uint8)
    rays_total = 0.0

    if limit_batches is not None:
        n_batches = min(n_batches, limit_batches)

    # pipelined batch loop: keep a few batches in flight so the device->
    # host readback of batch b overlaps batch b+1..b+k's compute. Drains
    # run on a worker thread: device_get releases the GIL during the
    # transfer, so fetching batch b overlaps dispatching b+1..b+k
    pipeline_depth = 8
    in_flight: list = []
    from concurrent.futures import ThreadPoolExecutor

    drain_pool = ThreadPoolExecutor(max_workers=1)

    def drain_sync(entry):
        nonlocal rays_total
        b, rgb, rays = entry
        # ONE device_get for both outputs (one round trip per batch)
        rgb_h, rays_h = jax.device_get((rgb, rays))
        for j in range(rgb_h.shape[0]):
            bj = b + j
            if bj >= n_batches:
                continue  # clamped duplicate of the last batch
            lo = bj * batch_pixels
            hi = min((bj + 1) * batch_pixels, n_pixels)
            if hi > lo:
                out[perm[lo:hi]] = rgb_h[j, : hi - lo]
            rays_total += float(rays_h[j])
            if progress is not None:
                progress(bj + 1, n_batches)

    def drain(entry):
        in_flight.append(drain_pool.submit(drain_sync, entry))
        while len(in_flight) > pipeline_depth:
            in_flight.pop(0).result()

    # ONE host->device upload of the full pixel list per frame shape
    # (cached); batches slice it inside the jitted program
    xs_dev, ys_dev = _pixel_tables_device(width, height, pad)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        everywhere = NamedSharding(mesh, P())
        scene, xs_dev, ys_dev = jax.device_put(
            (scene, xs_dev, ys_dev), everywhere
        )

    t0 = time.perf_counter()
    kw = dict(
        width=width, height=height, spp=spp, max_bounces=max_bounces,
        method=method, texture_mode=texture_mode, compact=compact,
        rr=rr, nee=nee, tonemap=tonemap, interpret=interpret,
    )
    # k_group is part of the compiled program's static shape: a warmup
    # run MUST use the same value as the timed run (bench.py pins it), or
    # the timed run compiles a new program inside the timer.
    if mesh is not None:
        k_group = mesh.devices.size  # one batch per device per dispatch
    else:
        k_group = max(1, min(k_group or 4, n_batches))
    if accumulate is None:
        accumulate = mesh is None and progress is None
    if accumulate and mesh is None:
        n_groups_full = (n_batches_full + k_group - 1) // k_group
        acc = jnp.zeros(
            (n_groups_full * k_group * batch_pixels, 3), jnp.uint8
        )
        rays_acc = jnp.zeros((n_groups_full * k_group,), jnp.float32)
        for b in range(0, n_batches, k_group):
            acc, rays_acc = render_batches_grouped_acc(
                scene, xs_dev, ys_dev, key, jnp.uint32(b), acc,
                rays_acc, batch_px=batch_pixels, k_group=k_group, **kw
            )
            if progress is not None:  # dispatch-enqueue progress
                progress(min(b + k_group, n_batches), n_batches)
        acc_h, rays_h = jax.device_get((acc, rays_acc))
        out[perm] = acc_h[:n_pixels]
        rays_total = float(np.sum(rays_h[:n_batches], dtype=np.float64))
        drain_pool.shutdown(wait=True)
    else:
        for b in range(0, n_batches, k_group):
            if mesh is None:
                rgb, rays = render_batches_grouped(
                    scene, xs_dev, ys_dev, key, jnp.uint32(b),
                    batch_px=batch_pixels, k_group=k_group, **kw
                )
            else:
                rgb, rays = render_batch_sharded(
                    scene, xs_dev, ys_dev, key, jnp.uint32(b), mesh=mesh,
                    batch_px=batch_pixels, **kw
                )
            drain((b, rgb, rays))
        for f in in_flight:
            f.result()
        drain_pool.shutdown(wait=True)
    wall_ms = (time.perf_counter() - t0) * 1e3

    img = out[:n_pixels].reshape(height, width, 3)

    stats = RenderStats(
        wall_ms=wall_ms,
        samples=n_pixels * spp,
        rays_traced=int(rays_total),
        batches=n_batches,
    )
    return img, stats
