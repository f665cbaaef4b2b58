"""Host-side implicit 8-ary BVH construction.

Ports the reference algorithm (scene.c:203-426) to vectorized numpy:

- complete implicit tree, fan-out 8; node i's children are 8*i + 1 + j
- depth = smallest d with 8**d >= ceil(n/8) (bvh_required_depth,
  scene.c:224-233) — we clamp to >= 1 so tiny scenes (<= 8 triangles, e.g.
  quad.obj) still get a valid root node; the reference under-allocates there
- splitter: partition counts into per-child multiples (scene.c:235-242), then
  for each of the 3 axes sort the slice by centroid (sum of vertex coords,
  scene.c:203-222) and keep the axis minimizing the sum of the two child AABB
  surface areas (scene.c:344-360); ties keep the later axis (the reference's
  `<=` compare)
- per-triangle AABBs are padded by +/-EPSILON (aabb_triangle, scene.c:177-188)
- leaf blocks of 8 triangles land at (child - last_row_offset) * 8 in the
  padded SoA array (scene.c:318-320)

Deviation from the reference (documented per SURVEY §7): slices with <= 8
triangles above the leaf row descend through a single-child chain to depth 0
instead of writing to a negative offset (latent reference bug for sparse
shapes); and the 12-thread task pool (scene.c:244-309) is replaced by
vectorized numpy argsorts — BVH build is host-side work, not a device concern.

Beyond-parity splitter (round 4, `sah=True` / RAYTPU_BVH_SAH): the
reference always splits a slice near its midpoint (partition_count) and
only chooses the AXIS by summed child surface area. Within the SAME
implicit topology the split POSITION is free to be any multiple of
`per_child` (every binary split at a multiple keeps all final child
ranges full blocks plus one remainder, so a node still finishes with
<= 8 children), so the SAH mode sweeps every valid position on all 3
axes with prefix/suffix AABBs and picks the minimum of the surface-area
heuristic cost SA_L*n_L + SA_R*n_R. The tree is IMAGE-INVARIANT — the
verified traversal is exact against the brute-force oracle for any valid
tree (tests/test_traverse_topk.py) — so splitter quality is purely a
performance lever: tighter child boxes mean fewer candidate leaf groups
per ray and fewer certificate suspects.
"""

from __future__ import annotations

import os

import numpy as np

from raytracing_jax import BVH_WIDTH, EPSILON
from raytracing_jax.models.scene import BVH, HostMesh

import jax.numpy as jnp

W = BVH_WIDTH


def n_leaf_nodes(depth: int) -> int:
    """8**depth (reference scene.h:103-109)."""
    return W**depth


def n_internal_nodes(depth: int) -> int:
    """sum_{i<depth} 8**i (reference scene.h:111-119)."""
    return sum(W**i for i in range(depth))


def required_depth(n_triangles: int) -> int:
    """bvh_required_depth (scene.c:224-233), clamped to >= 1."""
    blocks = (n_triangles + W - 1) // W
    n, depth = 1, 0
    while n < blocks:
        n *= W
        depth += 1
    return max(depth, 1)


def partition_count(n_triangles: int, per_child: int) -> int:
    """bvh_partition_triangles (scene.c:235-242), ported literally."""
    n, left = 0, n_triangles
    while n < n_triangles // 2 and left > per_child:
        n += per_child
        left -= per_child
    return n


#: default split mode: the reference's midpoint splitter (parity) unless
#: RAYTPU_BVH_SAH=1 selects the beyond-parity SAH position sweep
SAH_DEFAULT = os.environ.get("RAYTPU_BVH_SAH", "0") == "1"


def build_bvh(mesh: HostMesh, sah: bool | None = None):
    """Build the implicit BVH.

    sah: None -> SAH_DEFAULT; True sweeps split positions by SAH cost
    (see module docstring), False is the literal reference splitter.

    Returns (bvh, slot_map, capacity) where slot_map is an (capacity,) int64
    array mapping each padded leaf slot to a mesh triangle index (-1 = empty
    padding slot).
    """
    if sah is None:
        sah = SAH_DEFAULT
    n = mesh.positions.shape[0]
    depth = required_depth(n)
    n_internal = n_internal_nodes(depth)
    capacity = n_leaf_nodes(depth) * W

    mins = np.zeros((n_internal, W, 3), np.float32)
    maxs = np.zeros((n_internal, W, 3), np.float32)
    slot_map = np.full(capacity, -1, np.int64)

    if n > 0:
        pos = mesh.positions.astype(np.float64)
        centroids = pos.sum(axis=1)  # sum of vertex coords (scene.c:213-219)
        tri_min = pos.min(axis=1) - EPSILON  # aabb_triangle padding
        tri_max = pos.max(axis=1) + EPSILON

        order = np.arange(n, dtype=np.int64)
        _build_node(
            order, 0, n, 0, depth, n_internal,
            centroids, tri_min, tri_max, mins, maxs, slot_map, sah,
        )

    # row table: one node per 128-lane row, cols = component * 8 + child
    # for (min.xyz, max.xyz) + 80 pad lanes (see models/scene.py)
    nodes = np.zeros((n_internal, 128), np.float32)
    nodes[:, : 6 * W] = np.concatenate(
        [mins.transpose(0, 2, 1), maxs.transpose(0, 2, 1)], axis=1
    ).reshape(n_internal, 6 * W)

    return (
        BVH(
            nodes=jnp.asarray(nodes),
            depth=depth,
            last_row_offset=n_internal,
        ),
        slot_map,
        capacity,
    )


def _range_aabb(order, lo, hi, tri_min, tri_max):
    idx = order[lo:hi]
    return tri_min[idx].min(axis=0), tri_max[idx].max(axis=0)


def _build_node(
    order, lo, hi, index, depth, last_row_offset,
    centroids, tri_min, tri_max, mins, maxs, slot_map, sah=False,
):
    """Recursive node build (bvh_build, scene.c:311-414), iterative split."""
    if depth == 0:
        block = index - last_row_offset
        assert block >= 0, "leaf write above the leaf row"
        count = hi - lo
        assert count <= W
        slot_map[block * W : block * W + count] = order[lo:hi]
        return

    per_child = n_leaf_nodes(depth)

    # Iterative partition of [lo, hi) into <= 8 finished child ranges.
    slices = [(lo, hi)]
    finished = []
    while slices:
        sl, sh = slices.pop()
        ln = sh - sl
        if ln <= per_child:
            if ln > 0:
                finished.append((sl, sh))
            continue

        seg = order[sl:sh]
        if sah:
            best_axis, best_key, split = 0, np.inf, per_child
            perms = []
            # every multiple of per_child is a valid binary split: both
            # sides keep subdividing at multiples, so the node finishes
            # with full per_child blocks + one remainder (<= 8 children)
            ks = np.arange(1, -(-ln // per_child)) * per_child
            for axis in range(3):
                perm = np.argsort(centroids[seg, axis], kind="stable")
                perms.append(perm)
                lo_s = tri_min[seg[perm]]
                hi_s = tri_max[seg[perm]]
                pmin = np.minimum.accumulate(lo_s, axis=0)
                pmax = np.maximum.accumulate(hi_s, axis=0)
                smin = np.minimum.accumulate(lo_s[::-1], axis=0)[::-1]
                smax = np.maximum.accumulate(hi_s[::-1], axis=0)[::-1]
                sa_l = _sa_diag(pmax[ks - 1] - pmin[ks - 1])
                sa_r = _sa_diag(smax[ks] - smin[ks])
                cost = sa_l * ks + sa_r * (ln - ks)
                j = int(np.argmin(cost))
                if cost[j] <= best_key:  # later axis wins ties (reference)
                    best_key, best_axis, split = cost[j], axis, int(ks[j])
        else:
            split = partition_count(ln, per_child)

            # Pick the axis minimizing summed child surface area; the
            # reference fully sorts by each axis and keeps the last-best
            # (<= compare, scene.c:344-360).
            best_axis, best_key = 0, np.inf
            perms = []
            for axis in range(3):
                perm = np.argsort(centroids[seg, axis], kind="stable")
                perms.append(perm)
                left = seg[perm[:split]]
                right = seg[perm[split:]]
                sa = _sa(tri_min[left], tri_max[left]) + _sa(
                    tri_min[right], tri_max[right]
                )
                if sa <= best_key:
                    best_key, best_axis = sa, axis

        order[sl:sh] = seg[perms[best_axis]]
        slices.append((sl, sl + split))
        slices.append((sl + split, sh))

    assert len(finished) <= W, "more than 8 finished child slices"

    for i, (fl, fh) in enumerate(finished):
        lo3, hi3 = _range_aabb(order, fl, fh, tri_min, tri_max)
        mins[index, i] = lo3
        maxs[index, i] = hi3
        _build_node(
            order, fl, fh, W * index + 1 + i, depth - 1, last_row_offset,
            centroids, tri_min, tri_max, mins, maxs, slot_map, sah,
        )


def _sa_diag(d):
    """Surface areas of AABBs given their (m, 3) extent vectors."""
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def _sa(lo, hi):
    """Summed surface area of one AABB over a triangle set
    (aabb_surface_area, scene.c:157-162)."""
    if len(lo) == 0:
        return 0.0
    d = hi.max(axis=0) - lo.min(axis=0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
