"""The compiled intersection library's cases replayed through the port.

tests/golden/golden_intersect.bin holds 4,096 random cases of each kind
(triangle, sphere, AABB, and plane with point-in-triangle), written by
tools/golden_intersect.cpp from the reference's prebuilt intersection
library: each case's inputs and the library's decision and t. The port
replays them three ways:

  - `primitives`: the primitives of ops/intersect.py on every case, the
    batched [R, T] functions on 512-case chunks whose diagonals pair
    case i's ray with case i's primitive;
  - `sweep_cases`: K3, or its plain twin, on one one-row table a case;
  - `walk_cases`: K1, the sort of its keys and K2, or their plain twins,
    on one one-triangle cluster a case (perm [1, 128], the triangle in
    slot 0), in either tile layout;
  - `walk_cases_batched`: the same walks, all cases in one sweep of one
    launch each, every ray block's keys masked to its own case's cluster
    (the card's replay: a call a case runs the twins at about 4 ms).

A CPU tensor runs the twins through the wrappers; on the card `plain`
picks the twins, so the kernels can be held to them bit for bit
(chip_smoke.py phase 15). tests/test_torch_intersect_golden.py holds the
replays to the library's answers and the batched walk to walk_cases.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops import intersect, sweep

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "golden_intersect.bin")
N = 4096
CHUNK = 512
CLUSTER = 128         # slots of the one-triangle cluster (ops.bvh's size)
# each kind's record: name -> column (a scalar) or (start, stop)
RECORDS = {
    "tri": dict(v0=(0, 3), v1=(3, 6), v2=(6, 9), o=(9, 12), tmax=12,
                d=(14, 17), hit=17, t=18),
    "sph": dict(center=(0, 3), radius=3, o=(4, 7), d=(7, 10), tmax=10,
                hit=11, t=12, normal=(13, 16)),
    "box": dict(lo=(0, 3), hi=(3, 6), o=(6, 9), tmax=10, d=(11, 14), hit=14,
                t=15),
    "pln": dict(v0=(0, 3), v1=(3, 6), v2=(6, 9), p=(9, 12), D=12,
                n=(13, 16), inside=16, o=(17, 20), d=(20, 23), tmax=23,
                hit=24, t=25),
}
WIDTHS = {"tri": 19, "sph": 16, "box": 16, "pln": 26}
FLAGS = ("hit", "inside")


def load(path: str = GOLDEN, device="cpu") -> dict:
    """kind -> name -> tensor on device: the cases' inputs (f32) and the
    library's answers (flags as bool)."""
    data = np.fromfile(path, dtype=np.float32)
    if data.size != N * sum(WIDTHS.values()):
        raise ValueError(f"{path}: {data.size} floats, expected "
                         f"{N * sum(WIDTHS.values())}")
    out, off = {}, 0
    for kind, width in WIDTHS.items():
        rec = data[off:off + N * width].reshape(N, width)
        off += N * width
        cols = {}
        for name, col in RECORDS[kind].items():
            x = rec[:, slice(*col)] if isinstance(col, tuple) else rec[:, col]
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            cols[name] = x > 0 if name in FLAGS else x
        out[kind] = cols
    return out


def _paired(fn, n: int):
    """fn(s, e) -> [m, m] (or a tuple of them) over cases s:e; the
    diagonals of every chunk, concatenated: case i against case i."""
    parts = [fn(s, min(s + CHUNK, n)) for s in range(0, n, CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[k].diagonal() for p in parts])
                     for k in range(len(parts[0])))
    return torch.cat([p.diagonal() for p in parts])


def primitives(g: dict) -> dict:
    """The port's primitives on every case of g (load's cases): name ->
    tensor. The plane kind takes the library's n and D for its point and
    plane tests, as tests/test_intersect_golden.py does; the sphere normal
    is normalize(p - center) at the port's t."""
    tri, sph, box, pln = g["tri"], g["sph"], g["box"], g["pln"]
    out = {"tri_t": _paired(lambda s, e: intersect.intersect_triangles_t(
        tri["o"][s:e], tri["d"][s:e], tri["tmax"][s:e], tri["v0"][s:e],
        tri["v1"][s:e], tri["v2"][s:e]), N)}
    t = _paired(lambda s, e: intersect.intersect_spheres_t(
        sph["o"][s:e], sph["d"][s:e], sph["tmax"][s:e], sph["center"][s:e],
        sph["radius"][s:e]), N)
    tf = torch.where(torch.isfinite(t), t, 0.0)
    out["sph_t"] = t
    out["sph_normal"] = intersect.normalize(
        sph["o"] + tf[:, None] * sph["d"] - sph["center"])
    out["box_hit"], out["box_t"] = _paired(
        lambda s, e: intersect.intersect_aabb(
            box["o"][s:e], box["d"][s:e], box["tmax"][s:e], box["lo"][s:e],
            box["hi"][s:e]), N)
    out["pln_n"], out["pln_D"] = intersect.triangle_plane(
        pln["v0"], pln["v1"], pln["v2"])
    out["pln_inside"] = intersect.point_in_triangle(
        pln["v0"], pln["v1"], pln["v2"], pln["n"], pln["p"])
    out["pln_t"] = intersect.intersect_ray_plane_t(pln["o"], pln["d"],
                                                   pln["n"], pln["D"])
    return out


def _triangles(tri):
    """The cases' triangles as one mesh: vertices [3N, 3], tris [N, 3]."""
    n = tri["v0"].shape[0]
    verts = torch.stack([tri["v0"], tri["v1"], tri["v2"]], dim=1)
    tris = torch.arange(3 * n, device=verts.device).reshape(n, 3)
    return verts.reshape(-1, 3), tris


def _cases(idx, n):
    return range(n) if idx is None else [int(i) for i in idx]


def sweep_cases(tri: dict, plain: bool = False, idx=None):
    """K3 (or its twin, plain) on each case of tri (load's "tri") over a
    one-row table: (t [n], id [n] i32, 0 or -1). idx: the cases, all by
    default. The rows are packed once for all cases; a row's constants do
    not depend on the others."""
    verts, tris = _triangles(tri)
    valid = torch.ones(tris.shape[0], dtype=torch.bool, device=tris.device)
    table = sweep.pack_tri_table(verts, tris, valid)
    fn = sweep.closest_tris_plain if plain else sweep.closest_tris
    ts, ids = [], []
    for i in _cases(idx, table.shape[0]):
        t, j = fn(tri["o"][i:i + 1], tri["d"][i:i + 1],
                  tri["tmax"][i:i + 1], table[i:i + 1])
        ts.append(t)
        ids.append(j)
    return torch.cat(ts), torch.cat(ids)


def walk_cases(tri: dict, layout: str, plain: bool = False, idx=None,
               br: int = cs.DEFAULT_BR):
    """K1, the sort and K2's closest walk (or their twins, plain) on each
    case of tri over a one-triangle cluster in `layout`, sweep_setup's
    clusters a visit (1 triangle-major, SUPERCLUSTER field-major): (t [n],
    slot [n] i32, 0 or -1). The clusters are packed once for all cases."""
    verts, tris = _triangles(tri)
    n = tris.shape[0]
    perm = torch.full((n, CLUSTER), -1, dtype=torch.int64,
                      device=verts.device)
    perm[:, 0] = torch.arange(n, device=verts.device)
    aabbs, tiles, _ = cs.pack_cluster_tiles(verts, tris, perm, layout)
    keys_fn = cs.block_entry_keys_plain if plain else cs.block_entry_keys
    walk_fn = cs.cluster_walk_plain if plain else cs.cluster_walk
    ts, ids = [], []
    for i in _cases(idx, n):
        inp = cs.sweep_setup(tri["o"][i:i + 1], tri["d"][i:i + 1],
                             tri["tmax"][i:i + 1], aabbs[i:i + 1],
                             tiles[i:i + 1], layout, br, None)
        skeys, order = cs.sort_keys(keys_fn(inp.rays, inp.boxes))
        bt, bi, _, _ = walk_fn(order, skeys, inp.rays, inp.tiles,
                               layout=layout, sc_n=inp.sc_n)
        ts.append(bt[0, :1])
        ids.append(bi[0, :1])
    return torch.cat(ts), torch.cat(ids)


def walk_cases_batched(tri: dict, layout: str, plain: bool = False,
                       br: int = 32):
    """walk_cases's results for every case of tri in one sweep: ray block
    b holds case b's ray (and br - 1 dead rays), and its own one-triangle
    cluster sits at supercluster b, padded as sweep_setup pads a single
    cluster. K1 (or its twin) keys every block against every supercluster;
    all keys but a block's own are set to +inf before the sort, so K2 (or
    its twin) walks block b over case b's cluster alone, under the exit t
    of that cluster's box, as walk_cases's sweep does. (t [n], slot [n] in
    the case's cluster, 0 or -1)."""
    verts, tris = _triangles(tri)
    n, dev = tris.shape[0], verts.device
    sc_n = 1 if layout == "triangle" else cs.SUPERCLUSTER
    perm = torch.full((n * sc_n, CLUSTER), -1, dtype=torch.int64,
                      device=dev)
    perm[::sc_n, 0] = torch.arange(n, device=dev)
    aabbs, tiles, _ = cs.pack_cluster_tiles(verts, tris, perm, layout)
    own = aabbs[::sc_n]
    exit_t = cs.box_exit_t(tri["o"], tri["d"], own[:, 0:3], own[:, 3:6])
    rays = torch.zeros((n, 8, br), dtype=torch.float32, device=dev)
    rays[:, 6] = -1.0
    rays[:, 7] = -cs.FLT_MAX
    rays[:, :, 0] = torch.cat([tri["o"], tri["d"], tri["tmax"][:, None],
                               exit_t[:, None]], dim=1)
    boxes = cs.supercluster_boxes(aabbs, sc_n)
    keys_fn = cs.block_entry_keys_plain if plain else cs.block_entry_keys
    keys = keys_fn(rays, boxes)
    mine = torch.eye(n, dtype=torch.bool, device=dev)
    skeys, order = cs.sort_keys(torch.where(mine, keys, torch.inf))
    walk_fn = cs.cluster_walk_plain if plain else cs.cluster_walk
    bt, bi, _, _ = walk_fn(order, skeys, rays, tiles, layout=layout,
                           sc_n=sc_n)
    base = torch.arange(n, dtype=torch.int32, device=dev) * (sc_n * CLUSTER)
    return bt[:, 0], torch.where(bi[:, 0] >= 0, bi[:, 0] - base, -1)


def same(a, b) -> bool:
    """a and b hold equal values, with NaN at the same places (a card's
    NaN and the CPU's may carry other payloads)."""
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def agreement(hit, t, ref_hit, ref_t) -> tuple:
    """(share of equal decisions, largest |t - t_ref| where both hit)."""
    both = hit & ref_hit
    dt = (t[both] - ref_t[both]).abs()
    return (float((hit == ref_hit).float().mean()),
            float(dt.max()) if dt.numel() else 0.0)
