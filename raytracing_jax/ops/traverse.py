"""BVH traversal — component-plane, batch-minor layouts throughout.

Implementations of the reference's ordered closest-hit traversal
(ray_bvh_node_hit, raytracer.c:443-483), selected by `intersect_scene`'s
`method`:

1. "stack" — ops/traverse_stack.py: one Pallas kernel (Triton route), one
   ray per thread with its own stack. Exact; the GPU path.
2. "topk" — `intersect_bvh_verified`: dense level-synchronous top-k descent
   (fixed-shape XLA ops, no data-dependent control flow) plus a truncation
   certificate whose suspects are re-traversed wider, then by brute force.
   Exact; the CPU path.
3. "dfs" — `intersect_bvh`: ordered DFS with per-ray stacks, batch-
   synchronous under one `while_loop`. Exact; the semantics oracle.
4. "brute" — every ray against every triangle (the reference's own `#if 0`
   oracle, raytracer.c:497-503); `auto` picks it for tiny scenes.

All XLA intermediates keep the RAY axis minor: candidates/children/stack
slots lead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_jax import BVH_WIDTH, EPSILON
from raytracing_jax.ops import intersect
from raytracing_jax.utils.vec3 import Vec3

W = BVH_WIDTH
INF = jnp.float32(jnp.inf)


def _node_boxes(bvh, node):
    """Gather child AABBs for node ids `node` of any shape S.

    One row gather per node id, one transpose back to batch-minor, free
    static slicing. Returns (box_min, box_max): Vec3 with components
    (8,) + S.
    """
    table = bvh.nodes
    g = table[node]  # S + (128,)
    gt = jnp.moveaxis(g, -1, 0)  # (128,) + S
    c = gt.reshape((16, W) + node.shape).astype(jnp.float32)
    return (
        Vec3(x=c[0], y=c[1], z=c[2]),
        Vec3(x=c[3], y=c[4], z=c[5]),
    )


def _leaf_mt(origin, direction, triangles, tri_idx):
    """Moller-Trumbore against gathered triangle slots.

    tri_idx: int array shaped C + (R,); origin/direction Vec3 of (R,).
    Returns (t, u, v) shaped like tri_idx. Per-lane gathers; used by the
    oracle paths (DFS / chunked brute force).
    """
    v0 = triangles.v0.gather(tri_idx)
    e1 = triangles.e1.gather(tri_idx)
    e2 = triangles.e2.gather(tri_idx)
    return intersect.moller_trumbore(origin, direction, v0, e1, e2)


def _leaf_mt_rows(origin, direction, triangles, blocks):
    """Moller-Trumbore against whole leaf blocks via ROW gathers.

    The leaf row table packs each 8-triangle block into one 512-byte row
    (models/scene.py), so the fetch here is `n_rays * k_leaf` row gathers,
    followed by one transpose back to batch-minor and free static reshapes.

    blocks: (kl, R) block ids. Returns (t, u, v), each (kl*8, R),
    block-major rows (row = block * 8 + lane).
    """
    kl, r = blocks.shape
    g = triangles.leaf_rows[blocks]  # (kl, R, 128) row gather
    gt = jnp.transpose(g, (0, 2, 1))  # (kl, 128, R) — one bandwidth pass
    c = gt.reshape(kl, 16, W, r)  # 16 groups of 8 lanes; 9 used
    v0 = Vec3(c[:, 0], c[:, 1], c[:, 2])  # components (kl, 8, R)
    e1 = Vec3(c[:, 3], c[:, 4], c[:, 5])
    e2 = Vec3(c[:, 6], c[:, 7], c[:, 8])
    t, u, v = intersect.moller_trumbore(origin, direction, v0, e1, e2)
    return (
        t.reshape(kl * W, r),
        u.reshape(kl * W, r),
        v.reshape(kl * W, r),
    )


def _select_row(values, j):
    """values[j[r], r] per column as a one-hot mask + sum over the (small)
    leading axis."""
    c = values.shape[0]
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (c, 1), 0) == j[None, :]
    )
    return jnp.where(one_hot, values, 0).sum(axis=0, dtype=values.dtype)


def intersect_bvh(origin: Vec3, direction: Vec3, triangles, bvh, active=None):
    """Exact ordered DFS (the reference algorithm made iterative).

    Entries < last_row_offset are internal nodes; entries >= are leaf blocks
    (raytracer.c:474-476). Each iteration pops one entry per ray in
    lockstep: internal pops slab-test 8 children and push hits far-to-near
    (nearest pops first — the selection loop of raytracer.c:459-474); leaf
    pops run 8 triangle tests and tighten best_t, which prunes stale stack
    entries at pop time (raytracer.c:470).
    """
    r = origin.shape[0]
    depth = bvh.depth
    n_internal = bvh.n_internal
    n_blocks = triangles.capacity // W
    stack_size = 8 * (depth + 1)
    max_iters = n_internal + n_blocks + 8

    if active is None:
        active = jnp.ones((r,), bool)

    inv_dir = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    lane = jnp.arange(W, dtype=jnp.int32)
    rr = jnp.arange(r)
    slot_ids = jnp.arange(stack_size, dtype=jnp.int32)[:, None]  # (S, 1)

    state = {
        "sp": jnp.where(active, 1, 0).astype(jnp.int32),
        "stack_e": jnp.zeros((stack_size, r), jnp.int32),
        "stack_d": jnp.zeros((stack_size, r), jnp.float32),
        "best_t": jnp.full((r,), INF),
        "best_tri": jnp.full((r,), -1, jnp.int32),
        "best_u": jnp.zeros((r,), jnp.float32),
        "best_v": jnp.zeros((r,), jnp.float32),
        "it": jnp.int32(0),
    }

    def cond(st):
        return jnp.logical_and(jnp.any(st["sp"] > 0), st["it"] < max_iters)

    def body(st):
        sp = st["sp"]
        has = sp > 0
        top = jnp.maximum(sp - 1, 0)
        e = jnp.take_along_axis(st["stack_e"], top[None, :], axis=0)[0]
        d = jnp.take_along_axis(st["stack_d"], top[None, :], axis=0)[0]
        sp = jnp.where(has, sp - 1, sp)

        best_t = st["best_t"]
        process = has & (d < best_t)
        is_leaf = e >= n_internal

        # --- internal expand -------------------------------------------
        proc_int = process & ~is_leaf
        node = jnp.clip(e, 0, n_internal - 1)
        bmin, bmax = _node_boxes(bvh, node)  # Vec3 (8, R)
        dists = intersect.aabb_slab(
            origin, inv_dir, bmin, bmax, EPSILON, best_t
        )  # (8, R)
        dists = jnp.where(proc_int[None, :], dists, INF)

        order = jnp.argsort(dists, axis=0).astype(jnp.int32)
        sd = jnp.take_along_axis(dists, order, axis=0)  # ascending
        child = node[None, :] * W + 1 + order  # (8, R)

        stack_e, stack_d = st["stack_e"], st["stack_d"]
        # push far-to-near so the nearest child pops first
        for k in range(W - 1, -1, -1):
            m = proc_int & (sd[k] < best_t)
            one_hot = (slot_ids == sp[None, :]) & m[None, :]
            stack_e = jnp.where(one_hot, child[k][None, :], stack_e)
            stack_d = jnp.where(one_hot, sd[k][None, :], stack_d)
            sp = sp + m.astype(jnp.int32)

        # --- leaf block test --------------------------------------------
        proc_leaf = process & is_leaf
        blk = jnp.clip(e - n_internal, 0, n_blocks - 1)
        tri_idx = blk[None, :] * W + lane[:, None]  # (8, R)
        t, u, v = _leaf_mt(origin, direction, triangles, tri_idx)
        t = jnp.where(proc_leaf[None, :], t, INF)
        j = jnp.argmin(t, axis=0)
        tb = t[j, rr]
        better = tb < best_t

        return {
            "sp": sp,
            "stack_e": stack_e,
            "stack_d": stack_d,
            "best_t": jnp.where(better, tb, best_t),
            "best_tri": jnp.where(
                better, tri_idx[j, rr].astype(jnp.int32), st["best_tri"]
            ),
            "best_u": jnp.where(better, u[j, rr], st["best_u"]),
            "best_v": jnp.where(better, v[j, rr], st["best_v"]),
            "it": st["it"] + 1,
        }

    st = jax.lax.while_loop(cond, body, state)
    return {
        "t": st["best_t"],
        "tri": st["best_tri"],
        "u": st["best_u"],
        "v": st["best_v"],
    }


def intersect_bvh_topk(
    origin: Vec3, direction: Vec3, triangles, bvh, active=None, k: int = 8,
    k_leaf: int = 8, with_bound: bool = False,
):
    """Dense level-synchronous traversal (the first pass of "topk").

    Every ray descends the complete tree level-by-level keeping the `k`
    nearest hit children, ranked by AABB entry distance (the reference's
    nearest-first ordering, raytracer.c:459-474, made rank-based). The leaf
    stage tests the `k_leaf` nearest candidate blocks in ONE dense
    Moller-Trumbore batch. Every op is a fixed-shape sort/gather/VPU stage —
    no data-dependent control flow. Candidate axes lead; rays stay minor.

    with_bound=True additionally returns `dropped_min`, the entry distance
    of the nearest candidate ever truncated — the exactness certificate used
    by intersect_bvh_verified.

    Defaults (k=8, k_leaf=8) keep bounce-ray suspects rare enough that the
    O(suspects) escalation almost never overflows its compact buffer.
    """
    r = origin.shape[0]
    depth = bvh.depth
    n_internal = bvh.n_internal
    n_blocks = triangles.capacity // W

    inv_dir = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    lane = jnp.arange(W, dtype=jnp.int32)

    # level 0: root children
    bmin, bmax = _node_boxes(bvh, jnp.zeros((), jnp.int32))  # Vec3 (8,)
    dists = intersect.aabb_slab(
        origin, inv_dir,
        bmin.map(lambda a: a[:, None]), bmax.map(lambda a: a[:, None]),
        EPSILON, INF,
    )  # (8, R)
    if active is not None:
        dists = jnp.where(active[None, :], dists, INF)
    cand_ids = jnp.broadcast_to(
        lane[:, None] + 1, (W, r)
    ).astype(jnp.int32)
    cand_d = dists
    dropped_min = jnp.full((r,), INF)

    for _level in range(1, depth):
        kk = min(k, cand_d.shape[0])
        if cand_d.shape[0] > kk:
            # variadic sort: the ids ride the sort as payload
            sd, sids = jax.lax.sort((cand_d, cand_ids), dimension=0, num_keys=1)
            dropped_min = jnp.minimum(dropped_min, sd[kk])
            ids = sids[:kk]
            dk = sd[:kk]
        else:
            ids, dk = cand_ids, cand_d
        node = jnp.clip(ids, 0, n_internal - 1)  # (kk, R)
        bmin, bmax = _node_boxes(bvh, node)  # Vec3 (8, kk, R)
        d = intersect.aabb_slab(origin, inv_dir, bmin, bmax, EPSILON, INF)
        d = jnp.where(jnp.isfinite(dk)[None, :, :], d, INF)  # (8, kk, R)
        child = node[None, :, :] * W + 1 + lane[:, None, None]
        cand_ids = child.reshape(W * kk, r)
        cand_d = d.reshape(W * kk, r)

    # leaf stage
    kl = min(k_leaf, cand_d.shape[0])
    if cand_d.shape[0] > kl:
        sd, sids = jax.lax.sort((cand_d, cand_ids), dimension=0, num_keys=1)
        dropped_min = jnp.minimum(dropped_min, sd[kl])
        blk_ids = sids[:kl]
        blk_d = sd[:kl]
    else:
        blk_ids, blk_d = cand_ids, cand_d

    blocks = jnp.clip(blk_ids - n_internal, 0, n_blocks - 1)  # (kl, R)

    # leaf candidates processed in chunks so the (chunk, R, 128) row-gather
    # transient stays a few hundred MB at production batch sizes
    chunk = min(4, kl)
    best_t = jnp.full((r,), INF)
    best_tri = jnp.full((r,), -1, jnp.int32)
    best_u = jnp.zeros((r,), jnp.float32)
    best_v = jnp.zeros((r,), jnp.float32)
    for c0 in range(0, kl, chunk):
        ch = min(chunk, kl - c0)
        blk_c = blocks[c0 : c0 + ch]  # (ch, R)
        t, u, v = _leaf_mt_rows(origin, direction, triangles, blk_c)
        valid = jnp.broadcast_to(
            jnp.isfinite(blk_d[c0 : c0 + ch])[:, None, :], (ch, W, r)
        ).reshape(ch * W, r)
        t = jnp.where(valid, t, INF)
        tri_c = (
            blk_c[:, None, :] * W + lane[None, :, None]
        ).reshape(ch * W, r)

        j = jnp.argmin(t, axis=0)
        tb = t.min(axis=0)
        better = tb < best_t
        best_tri = jnp.where(
            better, _select_row(tri_c, j).astype(jnp.int32), best_tri
        )
        best_u = jnp.where(better, _select_row(u, j), best_u)
        best_v = jnp.where(better, _select_row(v, j), best_v)
        best_t = jnp.minimum(best_t, tb)

    hit = jnp.isfinite(best_t)
    out = {
        "t": best_t,
        "tri": jnp.where(hit, best_tri, -1),
        "u": best_u,
        "v": best_v,
    }
    if with_bound:
        out["dropped_min"] = dropped_min
    return out


def _merge_hits(a, b):
    """Pick the nearer hit per ray (b wins ties)."""
    b_wins = b["t"] <= a["t"]
    return {
        "t": jnp.where(b_wins, b["t"], a["t"]),
        "tri": jnp.where(b_wins, b["tri"], a["tri"]),
        "u": jnp.where(b_wins, b["u"], a["u"]),
        "v": jnp.where(b_wins, b["v"], a["v"]),
    }


def intersect_bruteforce_chunked(
    origin: Vec3, direction: Vec3, triangles, active=None,
    chunk: int | None = None,
):
    """Memory-bounded exhaustive oracle: fori_loop over triangle chunks so
    the (N, R) intermediate never materializes. Last-resort exact fallback.

    chunk=None sizes chunks adaptively: small ray buffers (the repair
    path, r~512) take the whole scene in one chunk, while large buffers
    stay bounded at ~32 MB of (chunk, R) intermediates."""
    r = origin.shape[0]
    n = triangles.capacity
    if chunk is None:
        chunk = int(min(n, max(4096, 8 * 2**20 // max(r, 1))))
    n_chunks = (n + chunk - 1) // chunk
    lane = jnp.arange(chunk, dtype=jnp.int32)

    def body(c, best):
        idx = jnp.clip(c * chunk + lane, 0, n - 1)[:, None]  # (chunk, 1)
        t, u, v = _leaf_mt(origin, direction, triangles, idx)  # (chunk, R)
        j = jnp.argmin(t, axis=0)
        cand = {
            "t": t.min(axis=0),
            "tri": idx[j, 0].astype(jnp.int32),
            "u": _select_row(u, j),
            "v": _select_row(v, j),
        }
        return _merge_hits(best, cand)

    best = {
        "t": jnp.full((r,), INF),
        "tri": jnp.full((r,), -1, jnp.int32),
        "u": jnp.zeros((r,)),
        "v": jnp.zeros((r,)),
    }
    best = jax.lax.fori_loop(0, n_chunks, body, best)
    if active is not None:
        best["t"] = jnp.where(active, best["t"], INF)
    best["tri"] = jnp.where(jnp.isfinite(best["t"]), best["tri"], -1)
    return best


def _repair_suspects(hit, suspect, wide_exact, origin, direction, s_cap):
    """Shared escalation: move suspect rays to the FRONT with one stable
    full-batch lax.sort (rays + hit state + original index ride as
    payloads), rerun the first `s_cap` lanes — a STATIC slice, no gather —
    through `wide_exact`, merge repairs lane-wise, and restore order with a
    second sort keyed on the original index.

    Runs behind jax.lax.cond so clean batches pay nothing; overflowing the
    buffer falls back to a full-batch wide pass (rare by construction).
    Triangle ids ride the sorts as f32 payloads — exact to 2^24."""
    r = origin.shape[0]
    s = min(s_cap, r)

    def escalate(args):
        hit, suspect = args
        n_sus = jnp.sum(suspect)

        def sorted_path(args2):
            hit, suspect = args2
            key = 1 - suspect.astype(jnp.int32)  # suspects first
            orig = jnp.arange(r, dtype=jnp.int32)
            ks, ox, oy, oz, dx, dy, dz, t0, u0, v0, tr0, oi = jax.lax.sort(
                (key, origin.x, origin.y, origin.z,
                 direction.x, direction.y, direction.z,
                 hit["t"], hit["u"], hit["v"],
                 hit["tri"].astype(jnp.float32), orig),
                num_keys=1,
            )
            act = ks[:s] == 0
            wide = wide_exact(
                Vec3(ox[:s], oy[:s], oz[:s]), Vec3(dx[:s], dy[:s], dz[:s]),
                act,
            )
            take = act & (wide["t"] <= t0[:s])
            t1 = t0.at[:s].set(jnp.where(take, wide["t"], t0[:s]))
            u1 = u0.at[:s].set(jnp.where(take, wide["u"], u0[:s]))
            v1 = v0.at[:s].set(jnp.where(take, wide["v"], v0[:s]))
            tr1 = tr0.at[:s].set(
                jnp.where(take, wide["tri"].astype(jnp.float32), tr0[:s])
            )
            # invert the permutation (oi is unique, so this is exact)
            _, t2, u2, v2, tr2 = jax.lax.sort(
                (oi, t1, u1, v1, tr1), num_keys=1
            )
            return {
                "t": t2, "u": u2, "v": v2, "tri": tr2.astype(jnp.int32),
            }

        def full_path(args2):
            hit, suspect = args2
            wide = wide_exact(origin, direction, suspect)
            return _merge_hits(hit, wide)

        return jax.lax.cond(
            n_sus <= s, sorted_path, full_path, (hit, suspect)
        )

    return jax.lax.cond(
        jnp.any(suspect), escalate, lambda a: a[0], (hit, suspect)
    )


def intersect_bvh_verified(
    origin: Vec3, direction: Vec3, triangles, bvh, active=None, k: int = 8,
    k_leaf: int = 8, max_suspects: int | None = None,
):
    """Exact dense traversal: top-k pass + truncation-bound verification.

    A ray is `suspect` only if some truncated candidate's AABB entry
    distance beats its found hit — the provable condition for a possible
    miss (AABB entry distance lower-bounds any contained hit). Suspects are
    rare, so they are COMPACTED into a small fixed buffer and
    re-traversed with a 4x-wider pass + chunked brute-force backstop; the
    whole repair runs behind jax.lax.cond, so clean batches pay nothing and
    dirty batches pay O(max_suspects), not O(R). In the measure-zero case
    that suspects overflow the buffer, a full-width wide pass handles the
    batch instead. Hit selection is exact — identical to the brute-force
    oracle (tests/test_traverse_topk.py).
    """
    hit = intersect_bvh_topk(
        origin, direction, triangles, bvh, active, k=k, k_leaf=k_leaf,
        with_bound=True,
    )
    suspect = hit.pop("dropped_min") < hit["t"]
    if active is not None:
        suspect = suspect & active

    r = origin.shape[0]
    n_blocks = triangles.capacity // W
    k2 = min(4 * k, 64)
    kl2 = min(4 * k_leaf, max(n_blocks, 1))
    s_cap = max_suspects or min(max(r // 32, 512), r)

    def wide_exact(o, d, act):
        """Wider pass + brute-force backstop on whatever batch it's given."""
        wide = intersect_bvh_topk(
            o, d, triangles, bvh, act, k=k2, k_leaf=kl2, with_bound=True,
        )
        still = (wide.pop("dropped_min") < wide["t"]) & act

        def brute(args2):
            wide, still = args2
            exact = intersect_bruteforce_chunked(o, d, triangles, still)
            return _merge_hits(wide, exact)

        return jax.lax.cond(
            jnp.any(still), brute, lambda a: a[0], (wide, still)
        )

    return _repair_suspects(hit, suspect, wide_exact, origin, direction, s_cap)


def intersect_scene(
    scene, origin: Vec3, direction: Vec3, active=None, method: str = "topk",
    k: int = 8, k_leaf: int = 8, interpret: bool = False,
):
    """ray_scene_hit (raytracer.c:497-503) + the sphere pass: nearest hit
    among BVH triangles and analytic spheres.

    method: "stack", "topk", "dfs" or "brute" (module docstring).
    interpret: run the "stack" kernel in Pallas interpret mode (tests).
    Returns dict(t, tri, sph, u, v); tri/sph are -1 where not the winner.
    """
    if method == "stack":
        from raytracing_jax.ops.traverse_stack import intersect_bvh_stack

        hit = intersect_bvh_stack(origin, direction, scene.triangles,
                                  scene.bvh, active, interpret=interpret)
    elif method == "dfs":
        hit = intersect_bvh(origin, direction, scene.triangles, scene.bvh, active)
    elif method == "topk":
        hit = intersect_bvh_verified(
            origin, direction, scene.triangles, scene.bvh, active,
            k=k, k_leaf=k_leaf,
        )
    elif method == "brute":
        hit = intersect.intersect_bruteforce(origin, direction, scene.triangles)
        if active is not None:
            hit["t"] = jnp.where(active, hit["t"], INF)
        hit["tri"] = jnp.where(jnp.isfinite(hit["t"]), hit["tri"], -1)
    else:
        raise ValueError(f"unknown traversal method '{method}'")

    t_tri = hit["t"]
    tri = jnp.where(jnp.isfinite(t_tri), hit["tri"], -1)

    t_sph, sph = intersect.intersect_spheres(
        origin, direction, scene.spheres, t_tri
    )
    if active is not None:
        sphere_wins = (t_sph < t_tri) & active
    else:
        sphere_wins = t_sph < t_tri
    return {
        "t": jnp.where(sphere_wins, t_sph, t_tri),
        "tri": jnp.where(sphere_wins, -1, tri),
        "sph": jnp.where(sphere_wins, sph, -1),
        "u": hit["u"],
        "v": hit["v"],
    }
