"""Exact closest-hit BVH traversal as one Pallas kernel (Triton route).

The reference's ordered traversal (ray_bvh_node_hit, raytracer.c:443-483)
made iterative, one ray per thread: each program owns a power-of-two block
of rays, and every ray walks the implicit 8-ary tree with its own stack.

- Reads: `bvh.nodes` and `triangles.leaf_rows` stay in device memory and are
  read by per-ray gathers through the L2. Node e's children are the
  implicit ids 8*e + 1 + k; ids >= n_internal are leaf blocks.
- Internal visit: slab-test the 8 child boxes, sort the (distance, id)
  pairs with an 8-input sorting network, and push the hit children
  far-to-near so the nearest pops first.
- Leaf visit: Moller-Trumbore against the block's 8 triangles; strictly
  closer hits replace the best, so `best_t` prunes every later pop.
- Stack: per-ray (distance, id) entries in a scratch output in device
  memory (Triton has no per-thread arrays), laid out slot-major inside each
  program's block so that lanes at the same depth touch adjacent words; it
  stays in L1/L2. An 8-ary tree of depth D needs at most 7*D + 1 entries,
  so a block of 32 rays holds (7*D + 1) * 32 * 8 bytes: 7.4 KB at depth 4.
  Block barriers order each pop before the pushes that may reuse its
  slot, and the pushes before the next pop.
  There is no truncation, so no certificate and no repair: the result
  equals the DFS oracle's for any depth and any triangle count.

Slab and triangle tests are the shared kernels of ops/intersect.py, so the
arithmetic is the oracle's; the GPU compiler may contract multiply-adds
differently, which moves t/u/v in the last bits only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracing_jax import BVH_WIDTH, EPSILON
from raytracing_jax.ops import intersect
from raytracing_jax.utils.vec3 import Vec3

W = BVH_WIDTH
INF = float("inf")

#: rays per program, one ray per thread: one warp per program measured
#: fastest on the H100 (PERF.md: 32x1 against 64x2 and 128x4); the loop
#: runs until the block's slowest ray is done, so small blocks waste less
BLOCK = 32
NUM_WARPS = 1

# optimal 19-comparator sorting network for 8 inputs
_SORT8 = (
    (0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
    (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
    (1, 2), (3, 4), (5, 6),
)


def stack_size(depth: int) -> int:
    """Deepest stack of the nearest-first walk of a depth-`depth` tree:
    7 pending siblings per level above the last expansion, plus its 8."""
    return 7 * depth + 1


def _sort8(d, ids):
    """Ascending (distance, id) sort of 8 per-lane pairs."""
    d, ids = list(d), list(ids)
    for i, j in _SORT8:
        swap = d[j] < d[i]
        d[i], d[j] = jnp.where(swap, d[j], d[i]), jnp.where(swap, d[i], d[j])
        ids[i], ids[j] = (
            jnp.where(swap, ids[j], ids[i]), jnp.where(swap, ids[i], ids[j])
        )
    return d, ids


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, act_ref,
            nodes_ref, leaves_ref,
            t_ref, tri_ref, u_ref, v_ref, stk_e_ref, stk_d_ref,
            *, n_internal, n_blocks, block, sync_block):
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    origin = Vec3(ox_ref[...], oy_ref[...], oz_ref[...])
    direction = Vec3(dx_ref[...], dy_ref[...], dz_ref[...])
    inv_dir = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    active = act_ref[...] != 0

    def sync():
        # a lane may be owned by different threads at the loads and at the
        # stores of its stack slots; a block barrier orders each pop before
        # the pushes that may reuse its slot, and the pushes before the
        # next pop
        if sync_block:
            plgpu.debug_barrier()

    # the root is entry 0 of every active ray's stack
    stk_e_ref[lane] = jnp.zeros((block,), jnp.int32)
    stk_d_ref[lane] = jnp.full((block,), -INF, jnp.float32)
    sync()
    sp = jnp.where(active, 1, 0).astype(jnp.int32)
    best_t = jnp.full((block,), INF, jnp.float32)
    best_tri = jnp.full((block,), -1, jnp.int32)
    zero = jnp.zeros((block,), jnp.float32)

    def cond(c):
        return jnp.max(c[0]) > 0

    def body(c):
        sp, best_t, best_tri, best_u, best_v = c
        has = sp > 0
        slot = jnp.maximum(sp - 1, 0) * block + lane
        e = stk_e_ref[slot]
        d = stk_d_ref[slot]
        sp = jnp.where(has, sp - 1, sp)
        process = has & (d < best_t)
        is_leaf = e >= n_internal
        proc_int = process & ~is_leaf
        proc_leaf = process & is_leaf

        def expand(sp):
            node = jnp.clip(e, 0, n_internal - 1)
            dist, ids = [], []
            for k in range(W):
                col = [nodes_ref[node, c * W + k] for c in range(6)]
                dk = intersect.aabb_slab(
                    origin, inv_dir, Vec3(*col[:3]), Vec3(*col[3:]),
                    EPSILON, best_t,
                )
                dist.append(jnp.where(proc_int, dk, INF))
                ids.append(node * W + 1 + k)
            dist, ids = _sort8(dist, ids)
            sync()
            for k in range(W - 1, -1, -1):
                push = proc_int & (dist[k] < best_t)
                at = sp * block + lane
                plgpu.store(stk_e_ref.at[at], ids[k], mask=push)
                plgpu.store(stk_d_ref.at[at], dist[k], mask=push)
                sp = sp + push.astype(jnp.int32)
            sync()
            return sp

        def leaf(best):
            best_t, best_tri, best_u, best_v = best
            blk = jnp.clip(e - n_internal, 0, n_blocks - 1)
            for k in range(W):
                col = [leaves_ref[blk, c * W + k] for c in range(9)]
                t, u, v = intersect.moller_trumbore(
                    origin, direction, Vec3(*col[0:3]), Vec3(*col[3:6]),
                    Vec3(*col[6:9]),
                )
                better = proc_leaf & (t < best_t)
                best_t = jnp.where(better, t, best_t)
                best_tri = jnp.where(better, blk * W + k, best_tri)
                best_u = jnp.where(better, u, best_u)
                best_v = jnp.where(better, v, best_v)
            return best_t, best_tri, best_u, best_v

        sp = jax.lax.cond(
            jnp.max(proc_int.astype(jnp.int32)) > 0, expand, lambda s: s, sp
        )
        best = jax.lax.cond(
            jnp.max(proc_leaf.astype(jnp.int32)) > 0, leaf, lambda b: b,
            (best_t, best_tri, best_u, best_v),
        )
        return (sp, *best)

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(
        cond, body, (sp, best_t, best_tri, zero, zero)
    )
    t_ref[...] = best_t
    tri_ref[...] = jnp.where(best_t < INF, best_tri, -1)
    u_ref[...] = best_u
    v_ref[...] = best_v


@functools.partial(
    jax.jit, static_argnames=("block", "num_warps", "interpret")
)
def intersect_bvh_stack(origin: Vec3, direction: Vec3, triangles, bvh,
                        active=None, *, block: int = BLOCK,
                        num_warps: int = NUM_WARPS, interpret: bool = False):
    """Exact closest hit of every ray: dict(t, tri, u, v) of (R,) arrays,
    t = +inf and tri = -1 on a miss or an inactive lane (the contract of
    traverse.intersect_bvh).

    Rays are padded to a multiple of `block` with inactive lanes. The
    kernel compiles for the GPU through Triton; `interpret=True` runs the
    same kernel body on any backend (tests)."""
    r = origin.shape[0]
    r_pad = max(block, -(-r // block) * block)
    n_prog = r_pad // block
    s = stack_size(bvh.depth)

    def pad(a, fill):
        return jnp.pad(a, (0, r_pad - r), constant_values=fill)

    act = (
        jnp.ones((r,), jnp.int32) if active is None
        else active.astype(jnp.int32)
    )
    args = [
        pad(origin.x, 0.0), pad(origin.y, 0.0), pad(origin.z, 0.0),
        pad(direction.x, 1.0), pad(direction.y, 1.0), pad(direction.z, 1.0),
        pad(act, 0),
        bvh.nodes, triangles.leaf_rows,
    ]
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec()  # the whole table, read by gathers
    stk_spec = pl.BlockSpec((s * block,), lambda i: (i,))
    kernel = functools.partial(
        _kernel, n_internal=bvh.n_internal,
        n_blocks=triangles.capacity // W, block=block,
        sync_block=not interpret,  # the interpreter runs lanes in order
    )
    f32 = jnp.float32
    t, tri, u, v, _, _ = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((r_pad,), f32),
            jax.ShapeDtypeStruct((r_pad,), jnp.int32),
            jax.ShapeDtypeStruct((r_pad,), f32),
            jax.ShapeDtypeStruct((r_pad,), f32),
            jax.ShapeDtypeStruct((n_prog * s * block,), jnp.int32),
            jax.ShapeDtypeStruct((n_prog * s * block,), f32),
        ),
        grid=(n_prog,),
        in_specs=[ray_spec] * 7 + [whole, whole],
        out_specs=[ray_spec] * 4 + [stk_spec, stk_spec],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_stack_traverse",
    )(*args)
    return {"t": t[:r], "tri": tri[:r], "u": u[:r], "v": v[:r]}
