"""The least time the card could take for each kernel's work: the larger of
its operations over the peak rate for their type and its bytes (each input
read once, each output written once) over the memory rate.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit):
67 TFLOP/s in float32 outside the tensor cores (an FMA counts as two),
495 TFLOP/s in TF32 on the tensor cores, 3.35 TB/s of device memory.

Operations are float32 add, subtract, multiply, divide (one each), min and
max; compares and selects are not counted. They are counted from the
kernels' code for the work the run's data needs: a ray-triangle test is
its plane t for every pair of a live ray and a triangle the kernel must
look at, and the edge tests only for a pair whose plane t could be the
answer (0 <= t <= tmax, and not past the ray's final best t). A kernel
cannot know the final best in advance and follows more plane t's up (its
running best lies above the final one), so it does at least the counted
work. The kernels are built without FMA contraction, so each counted
operation is an instruction of their own while the peak counts an FMA as
two: a kernel that did only the counted work at the full issue rate would
reach about half the float32 peak.
"""

from __future__ import annotations

import torch

from cge_tpu_torch.ops import cluster_sweep as cs

FP32_PEAK = 67e12
TF32_PEAK = 495e12
MEM_BW = 3.35e12

# operations per (live ray, box) pair of K1: per axis two subtractions
# and two multiplies (12; where the direction's octant is known, the near
# and far planes need no per-axis min / max), the nearest / farthest
# combine (4), the clamp at 0, tfar against tmax and the running minimum
KEYS_OPS = 19
# per (live ray, triangle slot) pair of K2's dense tile, the plane t: d.n
# (5), o.n (5, hoisted per tile with a shared origin), D - o.n and the
# divide (2); per pair that needs them, the hit point (6) and three edge
# planes (6 each)
WALK_PLANE_OPS = 12
WALK_PLANE_OPS_SHARED = 7
WALK_EDGE_OPS = 24
# refine's per (live ray, member) slab entry: K1's without the running
# minimum
REFINE_OPS = KEYS_OPS - 1
# the mxu tile: six TF32 products of the [4C, 8] x [8, 2] contraction per
# pair (768 flops on the tensor cores); on the float32 units the divide
# per pair and three edge tests (2 each) per pair that needs them
MXU_TENSOR_OPS = 6 * 4 * 8 * 2 * 2
MXU_PLANE_OPS = 1
MXU_EDGE_OPS = 6
# per (live ray, valid triangle) pair of K3, the plane t: d.n (5), o.n (5),
# D - o.n and the divide (2); per pair that needs them, the hit point (6)
# and per edge p - a (3), the cross product with the hoisted edge vector
# (9) and its dot with n (5). The edge vectors b - a cost 9 per triangle
# and block, not counted.
SWEEP_PLANE_OPS = 12
SWEEP_EDGE_OPS = 57


def bound(ops: float, nbytes: float, tensor_ops: float = 0.0) -> tuple:
    """(bound ms, "operations" or "bytes"): float32 ops at FP32_PEAK,
    tensor ops at TF32_PEAK, bytes at MEM_BW; the larger time bounds."""
    t_ops = max(ops / FP32_PEAK, tensor_ops / TF32_PEAK)
    t_mem = nbytes / MEM_BW
    if t_ops >= t_mem:
        return t_ops * 1e3, "operations"
    return t_mem * 1e3, "bytes"


def _needs_edges(t, tm, best):
    """Pairs whose plane t could be the answer: 0 <= t <= tmax, finite, and
    not past the ray's final best t."""
    return (t >= 0) & (t <= tm) & (t < torch.inf) & (t <= best)


def keys_bound(rays, n_boxes: int) -> tuple:
    """K1 on packed rays [NB, 8, BR] and n_boxes boxes."""
    NB, _, BR = rays.shape
    live = int((rays[:, 6] >= 0).sum())
    nbytes = rays.numel() * 4 + n_boxes * 32 + NB * n_boxes * 4
    return bound(live * n_boxes * KEYS_OPS, nbytes)


def walk_edge_pairs(order, rays, tiles, out, *, layout: str, sc_n: int,
                    any_hit: bool = False, shared_origin: bool = False) -> int:
    """Pairs of a live ray and a slot of a visited tile that need the edge
    tests, from the walk's result out = (best t, ids, visits, dense): the
    blocks' visits in their order, each tile's plane t as the twin computes
    it. Closest hit: 0 <= t <= min(tmax, final best t). Any hit: those
    pairs of a ray that ends unblocked, and one pair of a blocked ray."""
    best_t, best_i, visits, _ = out
    tri = tiles.transpose(1, 2) if layout == "field" else tiles
    if any_hit:
        blocked = best_i == 1
        best = torch.where(blocked, -torch.inf, torch.inf)
        n = blocked.sum()
    else:
        best = best_t
        n = torch.zeros((), dtype=torch.int64, device=rays.device)
    for step in range(int(visits.max()) if visits.numel() else 0):
        act = torch.nonzero(visits > step)[:, 0]
        r = rays[act]
        sc = order[act, step].long()
        for m in range(sc_n):
            t, _ = cs._tile_vpu(tri[sc * sc_n + m], r, shared_origin)
            n = n + _needs_edges(t, r[:, 6, None],
                                 best[act][:, None]).sum()
    return int(n)


def walk_bound(order, rays, tiles, out, *, layout: str, sc_n: int,
               any_hit: bool = False, shared_origin: bool = False,
               refine: bool = False, mxu: bool = False) -> tuple:
    """K2 on packed rays [NB, 8, BR], from the run's result out = (best t,
    ids, visits, dense tiles): every live ray of a block against each dense
    tile's C slots, the edge tests where walk_edge_pairs needs them
    (refine: and each visited member's box)."""
    _, _, visits, dense = out
    C = tiles.shape[2] if layout == "field" else tiles.shape[1]
    live = (rays[:, 6] >= 0).sum(dim=1).long()
    pairs = int((dense.long() * live).sum()) * C
    edges = walk_edge_pairs(order, rays, tiles, out, layout=layout,
                            sc_n=sc_n, any_hit=any_hit,
                            shared_origin=shared_origin)
    tensor = 0.0
    if mxu:
        ops = pairs * MXU_PLANE_OPS + edges * MXU_EDGE_OPS
        tensor = pairs * MXU_TENSOR_OPS
    else:
        plane = WALK_PLANE_OPS_SHARED if shared_origin else WALK_PLANE_OPS
        ops = pairs * plane + edges * WALK_EDGE_OPS
    if refine:
        ops += int((visits.long() * live).sum()) * sc_n * REFINE_OPS
    tiles_bytes = min(int(dense.sum()), tiles.shape[0]) * C * 64
    nbytes = (rays.numel() * 4 + int(visits.sum()) * 8 + tiles_bytes
              + rays.shape[0] * rays.shape[2] * 8 + rays.shape[0] * 8)
    return bound(ops, nbytes, tensor)


def sweep_edge_pairs(o, d, tmax, table, best_t, ray_tile: int = 1024) -> int:
    """Pairs of a live ray and a valid row of K3's table that need the edge
    tests: 0 <= t <= min(tmax, final best t), the plane t as the twin
    computes it."""
    nx, ny, nz, D = (table[None, :, k] for k in (9, 10, 11, 12))
    valid = table[None, :, 13] > 0
    n = torch.zeros((), dtype=torch.int64, device=o.device)
    for r0 in range(0, o.shape[0], ray_tile):
        ox, oy, oz = (o[r0:r0 + ray_tile, k, None] for k in range(3))
        dx, dy, dz = (d[r0:r0 + ray_tile, k, None] for k in range(3))
        denom = (dx * nx + dy * ny) + dz * nz
        t = (D - ((ox * nx + oy * ny) + oz * nz)) / denom
        n = n + (valid & _needs_edges(t, tmax[r0:r0 + ray_tile, None],
                                      best_t[r0:r0 + ray_tile, None])).sum()
    return int(n)


def sweep_bound(o, d, tmax, table, best_t) -> tuple:
    """K3 on R rays against the [T, 16] table, from the run's best t [R]:
    the plane t of every (live ray, valid row) pair, the edge tests where
    sweep_edge_pairs needs them."""
    R, T = o.shape[0], table.shape[0]
    live = int((tmax >= 0).sum())
    pairs = live * int((table[:, 13] > 0).sum())
    edges = sweep_edge_pairs(o, d, tmax, table, best_t)
    nbytes = R * 28 + T * 64 + R * 8
    return bound(pairs * SWEEP_PLANE_OPS + edges * SWEEP_EDGE_OPS, nbytes)


def stream_bound(n_floats: int, w: int) -> tuple:
    """K4: one add per float read."""
    return bound(n_floats, n_floats * 4 + w * 4)
