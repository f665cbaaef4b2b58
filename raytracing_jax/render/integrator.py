"""Wavefront path integrator (component-plane state).

The reference's per-pixel recursive bounce loop (cast_ray, raytracer.c:505-558)
re-designed as a bounce-synchronous batched loop over a flat ray arena: every
bounce intersects, shades, and advances ALL rays at once with masks — the
accelerator shape of the algorithm (SURVEY §7). All per-ray vectors are Vec3
component planes, so state arrays stay batch-minor.

Semantics preserved exactly:
- throughput ("accumulated_tint") x per-bounce shader tint; accumulated
  emission; shader-driven terminate (raytracer.c:506-544)
- hits whose geometric OR shading normal faces along the ray are skipped by
  re-casting from an epsilon-advanced origin — and this consumes a bounce
  (raytracer.c:516-521)
- next origin biased +/-epsilon along the geometric normal depending on which
  side the sampled direction leaves (the normal-mapping leak guard,
  raytracer.c:546-552)
- miss returns background * throughput + emission and stops
  (raytracer.c:553-555); rays that exhaust max_bounces return emission only
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_jax import EPSILON
from raytracing_jax.ops import background as bg_ops
from raytracing_jax.ops import disney, traverse
from raytracing_jax.utils.vec3 import Vec3


def _gather_hit_geometry(scene, origin: Vec3, direction: Vec3, hit):
    """Deferred attribute interpolation: gather per-hit vertex data by the
    winning triangle index (the SIMD kernel interpolated inline,
    raytracer.c:159-183; we defer it to one dense stage per bounce): ONE
    attribute-row gather per ray (models/scene.py ATTR_* layout).
    """
    from raytracing_jax.models.scene import (
        ATTR_BTN, ATTR_MAT, ATTR_N0, ATTR_N1, ATTR_N2, ATTR_NG,
        ATTR_TAN, ATTR_UV,
    )

    tris = scene.triangles
    tri = jnp.maximum(hit["tri"], 0)
    u = hit["u"]
    v = hit["v"]
    w = 1.0 - u - v

    a = jnp.transpose(tris.attr_rows[tri])  # (128, R), batch-minor

    def vec(c):
        return Vec3(a[c], a[c + 1], a[c + 2])

    n0, n1, n2 = vec(ATTR_N0), vec(ATTR_N1), vec(ATTR_N2)
    normal = n0 * w + n1 * u + n2 * v
    uv_u = a[ATTR_UV] * w + a[ATTR_UV + 2] * u + a[ATTR_UV + 4] * v
    uv_v = a[ATTR_UV + 1] * w + a[ATTR_UV + 3] * u + a[ATTR_UV + 5] * v
    ng = vec(ATTR_NG)
    tangent = vec(ATTR_TAN)
    bitangent = vec(ATTR_BTN)
    mat_id = a[ATTR_MAT].astype(jnp.int32)

    point = origin + direction * hit["t"]

    if scene.spheres.count > 0:
        sph = jnp.maximum(hit["sph"], 0)
        is_sph = hit["sph"] >= 0
        center = scene.spheres.center.gather(sph)
        radius = scene.spheres.radius[sph]
        n_sph = (point - center) * (1.0 / radius)
        t_sph, b_sph = disney.basis(direction, n_sph)
        normal = Vec3.where(is_sph, n_sph, normal)
        ng = Vec3.where(is_sph, n_sph, ng)
        tangent = Vec3.where(is_sph, t_sph, tangent)
        bitangent = Vec3.where(is_sph, b_sph, bitangent)
        uv_u = jnp.where(is_sph, 0.0, uv_u)
        uv_v = jnp.where(is_sph, 0.0, uv_v)
        mat_id = jnp.where(is_sph, scene.spheres.mat_id[sph], mat_id)

    return {
        "point": point,
        "normal": normal,  # unnormalized interpolated normal
        "ng": ng,
        "tangent": tangent,
        "bitangent": bitangent,
        "uv_u": uv_u,
        "uv_v": uv_v,
        "mat_id": mat_id,
    }


#: first bounce eligible for Russian roulette (when enabled): short paths
#: carry most of the image energy and are never gambled away
RR_START = 3


def bounce_step(scene, st, rand4, method: str = "topk",
                texture_mode: str = "bilinear", rr: bool = False,
                bounce_i=None, nee: bool = False, rand2=None,
                interpret: bool = False):
    """ONE wavefront bounce over a state dict of per-ray planes.

    st: dict(origin, direction, throughput, radiance: Vec3; active: bool;
    rays: f32 scalar). rand4: (4, R) uniforms for the material stage.
    The single source of per-bounce semantics: trace()/trace_bucketed()
    below both call it. method/interpret go to traverse.intersect_scene.

    rr: Russian-roulette path termination (BEYOND-PARITY, default off —
    the reference integrator has none, raytracer.c:505-558): from bounce
    RR_START, a continuing path survives with p = clip(max(throughput),
    0.05, 1) and its throughput is divided by p — the standard unbiased
    estimator. Uses rand4[3] (the spare channel). bounce_i: traced bounce
    index (required when rr=True).

    nee (BEYOND-PARITY, default off): next-event estimation of the
    environment light with power-heuristic MIS. Each shaded vertex draws
    one uniform-sphere light sample (rand2), casts a shadow ray, and adds
    throughput x nee_partial when unoccluded; the ordinary miss
    contribution is MIS-weighted by the deterministic scatter pdf carried
    in st["prev_pdf"] (INF sentinel = previous vertex did no NEE -> full
    weight). Triangle emission stays unweighted (NEE samples only the env,
    so no double counting). Shadow rays count toward `rays`.
    """
    active = st["active"]
    o, d = st["origin"], st["direction"]
    r = o.shape[0]

    hit = traverse.intersect_scene(scene, o, d, active, method=method,
                                   interpret=interpret)
    rays = st["rays"] + jnp.sum(active).astype(jnp.float32)

    is_hit = active & jnp.isfinite(hit["t"])
    geom = _gather_hit_geometry(scene, o, d, hit)

    # backface skip: geometric OR shading normal along the ray
    # (raytracer.c:516-521)
    backface = is_hit & (
        (geom["ng"].dot(d) > 0.0) | (geom["normal"].dot(d) > 0.0)
    )
    shaded = is_hit & ~backface

    n_unit = geom["normal"].normalized()
    out = disney.shade(
        scene, d, n_unit, geom["ng"], geom["tangent"], geom["bitangent"],
        geom["uv_u"], geom["uv_v"], geom["mat_id"], rand4, texture_mode,
        nee=nee, rand2=rand2,
    )

    zero = Vec3.zeros((r,))
    radiance = st["radiance"] + Vec3.where(
        shaded, st["throughput"] * out["emission"], zero
    )

    # miss: background * throughput (raytracer.c:553-555); under NEE the
    # env contribution of a scattered ray carries its MIS weight
    miss = active & ~is_hit
    bg = bg_ops.eval_background(scene, d)
    if nee:
        pp = st["prev_pdf"]
        env = getattr(scene, "env_light", None)
        if env is not None:
            from raytracing_jax.ops import env_light as el

            pl = el.eval_pdf(env, d)  # per-direction light pdf
        else:
            pl = disney.UNIFORM_SPHERE_PDF
        w_brdf = jnp.where(
            jnp.isfinite(pp), (pp * pp) / (pp * pp + pl * pl), 1.0
        )
        bg = bg * w_brdf
    radiance = radiance + Vec3.where(miss, st["throughput"] * bg, zero)

    if nee:
        # shadow ray toward the env sample; origin epsilon rule as below
        wd = out["nee_dir"]
        sbias = jnp.where(geom["ng"].dot(wd) < 0.0, -EPSILON, EPSILON)
        s_org = geom["point"] + geom["ng"] * sbias
        shot = traverse.intersect_scene(scene, s_org, wd, shaded,
                                        method=method, interpret=interpret)
        lit = shaded & ~jnp.isfinite(shot["t"])
        radiance = radiance + Vec3.where(
            lit, st["throughput"] * out["nee_partial"], zero
        )
        rays = rays + jnp.sum(shaded).astype(jnp.float32)

    # terminated rays keep their accumulated emission and go inactive
    cont = shaded & ~out["terminate"]

    throughput = Vec3.where(
        cont, st["throughput"] * out["tint"], st["throughput"]
    )

    if rr:
        assert bounce_i is not None
        lum = jnp.maximum(
            jnp.maximum(throughput.x, throughput.y), throughput.z
        )
        p = jnp.clip(lum, 0.05, 1.0)
        gamble = cont & (bounce_i >= RR_START)
        kill = gamble & (rand4[3] >= p)
        cont = cont & ~kill
        scale = jnp.where(gamble & ~kill, 1.0 / p, 1.0)
        throughput = throughput * scale

    # next ray origin: epsilon rules (raytracer.c:520, 551-552)
    bias = jnp.where(
        geom["ng"].dot(out["direction"]) < 0.0, -EPSILON, EPSILON
    )
    origin_shaded = geom["point"] + geom["ng"] * bias
    origin_back = geom["point"] + d * EPSILON
    new_origin = Vec3.where(
        backface, origin_back, Vec3.where(cont, origin_shaded, o)
    )
    new_dir = Vec3.where(cont, out["direction"], d)

    res = {
        "origin": new_origin,
        "direction": new_dir,
        "throughput": throughput,
        "radiance": radiance,
        "active": (cont | backface),
        "rays": rays,
    }
    if "prev_pdf" in st:
        if nee:
            # backface re-casts continue the SAME segment: keep its pdf
            res["prev_pdf"] = jnp.where(
                backface, st["prev_pdf"],
                jnp.where(cont, out["pdf_eval"], jnp.inf),
            )
        else:
            res["prev_pdf"] = st["prev_pdf"]
    return res


def trace(scene, origin: Vec3, direction: Vec3, uniforms, max_bounces: int,
          method: str = "topk", texture_mode: str = "bilinear",
          rr: bool = False, nee: bool = False, nee_uniforms=None,
          interpret: bool = False):
    """Trace a batch of rays to completion.

    origin/direction: Vec3 of (R,); uniforms: (max_bounces, 4, R) pre-drawn
    threefry uniforms (lobe select, u1, u2, spare) — the stateless
    counter-based replacement for the reference's thread-local PCG stream
    (common.h:13-28, SURVEY §2.1).

    Returns (radiance Vec3 of (R,), rays_traced scalar) where rays_traced
    counts every scene intersection executed, including backface re-casts —
    the Mrays/s numerator (BASELINE.md measurement note).
    """
    r = origin.shape[0]

    state = {
        "origin": origin,
        "direction": direction,
        "throughput": Vec3.full((r,), 1.0),
        "radiance": Vec3.zeros((r,)),
        "active": jnp.ones((r,), bool),
        "rays": jnp.float32(0.0),
        "prev_pdf": jnp.full((r,), jnp.inf),
    }

    def bounce(i, st):
        return bounce_step(scene, st, uniforms[i], method, texture_mode,
                           rr=rr, bounce_i=i, nee=nee,
                           rand2=None if nee_uniforms is None
                           else nee_uniforms[i], interpret=interpret)

    # while-loop over bounces: a batch whose rays have ALL terminated (e.g.
    # a sky-only tile, or every path absorbed) stops early instead of
    # paying the full bounce budget — the wavefront analog of the
    # reference's per-pixel loop break (raytracer.c:539-556)
    def cond(iv):
        i, st = iv
        return jnp.logical_and(i < max_bounces, jnp.any(st["active"]))

    def body(iv):
        i, st = iv
        return i + 1, bounce(i, st)

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return st["radiance"], st["rays"]


# state-plane order for the bucket sort (all payloads are (R,) f32/i32)
_SORT_PLANES = (
    ("origin", "x"), ("origin", "y"), ("origin", "z"),
    ("direction", "x"), ("direction", "y"), ("direction", "z"),
    ("throughput", "x"), ("throughput", "y"), ("throughput", "z"),
    ("radiance", "x"), ("radiance", "y"), ("radiance", "z"),
)

#: smallest bucket width
_MIN_BUCKET = 4096


def trace_bucketed(scene, origin: Vec3, direction: Vec3, key,
                   max_bounces: int, method: str = "topk",
                   texture_mode: str = "bilinear", rr: bool = False,
                   nee: bool = False, interpret: bool = False):
    """trace() with on-device occupancy compaction — the wavefront
    work-pool of the reference (render_thread_proc's chunk stealing,
    raytracer.c:596-720) with zero host round-trips.

    After a few bounces most lanes are dead but a dense bounce still pays
    for all of them. Each bounce here first sorts live lanes to the front
    (one variadic lax.sort), then lax.switch picks the narrowest front
    slice that holds every live lane and runs bounce_step on THAT static
    shape only; the dead tail is carried through untouched. Lane order
    stays permuted across bounces; one final sort on the carried sample
    slot restores it.

    Per-sample RNG: uniforms derive from (key, SLOT, bounce) via
    vectorized threefry fold_in, where slot is the sample id carried
    through every permutation — so a sample's stream is
    PERMUTATION-INDEPENDENT and images are invariant to the compaction
    schedule (bucket widths, sort cadence). Differs from trace()'s
    pre-drawn stream; both are seed-deterministic.
    """
    r = origin.shape[0]

    # Decay-matched ladder, <=5 switch branches: /2 for the first step
    # (bounce-1 occupancy of a camera batch is typically ~30%, so a /4
    # first step would land back on full width), then /4 steps, floored
    # at _MIN_BUCKET. Each branch compiles its own copy of the bounce
    # program, so the branch count bounds compile time.
    widths = [r]
    div = 2
    while len(widths) < 5 and widths[-1] // div >= _MIN_BUCKET:
        widths.append(widths[-1] // div)
        div = 4
    if len(widths) >= 2 and (5 * r) // 16 >= _MIN_BUCKET:
        # an extra 5r/16 rung between r/2 and r/8: an added rung never adds
        # padding (each bounce picks the narrowest width that holds its
        # live count) and costs one more branch's compile. Widths need not
        # be powers of two — every branch is just a static front slice
        widths = sorted(set(widths) | {(5 * r) // 16}, reverse=True)

    state = {
        "origin": origin,
        "direction": direction,
        "throughput": Vec3.full((r,), 1.0),
        "radiance": Vec3.zeros((r,)),
        "active": jnp.ones((r,), bool),
        "slot": jnp.arange(r, dtype=jnp.int32),
        "rays": jnp.float32(0.0),
        "prev_pdf": jnp.full((r,), jnp.inf),
    }

    def compact(st):
        key = (~st["active"]).astype(jnp.int32)  # live lanes first
        planes = [getattr(st[name], c) for name, c in _SORT_PLANES]
        key_s, slot_s, pp_s, *planes_s = jax.lax.sort(
            (key, st["slot"], st["prev_pdf"], *planes), num_keys=1
        )
        new = dict(st)
        new["active"] = key_s == 0
        new["slot"] = slot_s
        new["prev_pdf"] = pp_s
        it = iter(planes_s)
        for name in ("origin", "direction", "throughput", "radiance"):
            new[name] = Vec3(next(it), next(it), next(it))
        return new

    def make_branch(w):
        def br(args):
            i, st = args
            head = {
                "origin": Vec3(*(getattr(st["origin"], c)[:w] for c in "xyz")),
                "direction": Vec3(
                    *(getattr(st["direction"], c)[:w] for c in "xyz")
                ),
                "throughput": Vec3(
                    *(getattr(st["throughput"], c)[:w] for c in "xyz")
                ),
                "radiance": Vec3(
                    *(getattr(st["radiance"], c)[:w] for c in "xyz")
                ),
                "active": st["active"][:w],
                "rays": st["rays"],
                "prev_pdf": st["prev_pdf"][:w],
            }
            # nee: 4 material + 2 light-sample + 1 env-CDF jitter. rr
            # additionally reads channel 3; plain tracing consumes only
            # the 3 BRDF channels. threefry counter semantics make
            # uniform(k, (m,)) the exact PREFIX of uniform(k, (n>m,)),
            # so narrowing the draw is bit-identical (tests/test_golden)
            # while skipping the unused per-lane bit generation
            nu = 7 if nee else (4 if rr else 3)

            def draw(s):
                k = jax.random.fold_in(jax.random.fold_in(key, s), i)
                return jax.random.uniform(k, (nu,), jnp.float32)

            u6 = jax.vmap(draw, out_axes=1)(st["slot"][:w])  # (nu, w)
            out = bounce_step(
                scene, head, u6[: min(nu, 4)], method, texture_mode,
                rr=rr, bounce_i=i, nee=nee,
                rand2=u6[4:nu] if nee else None, interpret=interpret,
            )
            new = dict(st)
            for name in ("origin", "direction", "throughput", "radiance"):
                new[name] = Vec3(
                    *(
                        jnp.concatenate(
                            [getattr(out[name], c), getattr(st[name], c)[w:]]
                        )
                        for c in "xyz"
                    )
                )
            new["active"] = jnp.concatenate(
                [out["active"], st["active"][w:]]
            )
            new["rays"] = out["rays"]
            new["prev_pdf"] = jnp.concatenate(
                [out["prev_pdf"], st["prev_pdf"][w:]]
            )
            return new

        return br

    branches = [make_branch(w) for w in widths]

    def cond(iv):
        i, k_prev, st = iv
        return jnp.logical_and(i < max_bounces, jnp.any(st["active"]))

    def body(iv):
        i, k_prev, st = iv
        n = jnp.sum(st["active"].astype(jnp.int32))
        # narrowest bucket that holds every live lane (monotone count)
        k_new = jnp.int32(0)
        for j, w in enumerate(widths[1:], start=1):
            k_new = jnp.where(n <= w, jnp.int32(j), k_new)
        # sort ONLY when it lets the bucket shrink: lanes never reactivate,
        # so every live lane already sits inside the previous front slice
        do_sort = k_new > k_prev
        st = jax.lax.cond(do_sort, compact, lambda s: s, st)
        k = jnp.where(do_sort, k_new, k_prev)
        st = jax.lax.switch(k, branches, (i, st))
        return i + 1, k, st

    _, _, st = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), state)
    )

    # undo the accumulated permutation
    _, rx, ry, rz = jax.lax.sort(
        (st["slot"], st["radiance"].x, st["radiance"].y, st["radiance"].z),
        num_keys=1,
    )
    return Vec3(rx, ry, rz), st["rays"]
