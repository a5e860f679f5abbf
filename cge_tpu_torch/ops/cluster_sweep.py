"""Cluster-culled closest-hit / any-hit sweep
(counterpart of cge_tpu/ops/pallas/cluster_sweep.py:76-708).

Triangles are pre-permuted into clusters of CLUSTER_SIZE (ops.bvh), grouped
into superclusters of `sc_n` consecutive clusters. One sweep runs:

  1. K1, the key pass: for every (ray block, supercluster) pair the entry t
     of the block's nearest live ray (`block_entry_keys`);
  2. a stable sort of each block's keys into its front-to-back visit order
     (`torch.sort`, in place of the JAX package's `lax.sort`);
  3. K2, the ordered walk: each ray block visits its superclusters in that
     order, tests every member cluster's triangles, and stops once the next
     key is behind every live ray's best t (`cluster_walk`).

K1 and K2 are CUDA kernels (csrc/cluster_sweep.cu). Beside each stands its
plain PyTorch twin (`block_entry_keys_plain`, `cluster_walk_plain`) with the
same visit order, stop bound, sentinels and tie rules. A wrapper runs the
twin for a tensor on the CPU and launches the kernel for a CUDA tensor;
there is no fallback between the two. `LAUNCHES` counts kernel launches, so
a run can show that it went through the kernels.

Sentinels (as in the JAX package):
  - pad rays carry tmax = -1 and exit t = -FLT_MAX; a ray that provably
    misses the scene box has exit t = -inf;
  - empty clusters have lo = +inf, hi = -inf; pad clusters FLT_MAX/-FLT_MAX;
    both are inverted boxes, which K1 never enters;
  - any-hit marks a blocked ray with best t = -3e38 and flag 1.
"""

from __future__ import annotations

import torch

from cge_tpu_torch import _kernels

DEFAULT_BR = 512
SUPERCLUSTER = 4
# tile stacks above this size are packed field-major, as the JAX package
# does; the layout then also sets the default clusters per visit
RESIDENT_TILE_BYTES = 4 * 1024 * 1024
FLT_MAX = 3.4028234663852886e38
DONE = -3.0e38                  # any-hit sentinel
LAYOUTS = ("triangle", "field")

# b_i = 1 kills every edge test of a pad triangle
_INVALID_ROW = [0.0] * 4 + [0.0, 0.0, 0.0, 1.0] * 3

LAUNCHES = {"keys": 0, "walk": 0}


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def pack_cluster_tiles(vertices, tris, perm, layout: str | None = None):
    """Per-cluster constants for the sweep. perm: [L, C] triangle ids (-1 =
    pad). Returns (aabbs [L, 8]: lo3, hi3, pad2; tiles; layout), where tiles
    holds per triangle (n, D, m0, b0, m1, b1, m2, b2) with m_i =
    cross(n, edge_i), b_i = m_i . v_i: [L, C, 16] for layout "triangle",
    [L, 16, C] for "field". None picks the layout by RESIDENT_TILE_BYTES."""
    L, C = perm.shape
    if layout is None:
        layout = "field" if L * C * 16 * 4 > RESIDENT_TILE_BYTES else "triangle"
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    valid = perm >= 0
    tv = vertices[tris[perm.clamp_min(0)]]              # [L, C, 3, 3]
    v0, v1, v2 = tv[:, :, 0], tv[:, :, 1], tv[:, :, 2]
    n = _cross(v1 - v0, v2 - v0)
    n = n / torch.sqrt(_dot3(n, n))[..., None]
    D = _dot3(n, v0)

    def edge_consts(va, vb):
        m = _cross(n, vb - va)
        return m, _dot3(m, va)

    m0, b0 = edge_consts(v0, v1)
    m1, b1 = edge_consts(v1, v2)
    m2, b2 = edge_consts(v2, v0)
    rows = torch.cat([n, D[..., None], m0, b0[..., None], m1, b1[..., None],
                      m2, b2[..., None]], dim=-1)         # [L, C, 16]
    inval = torch.tensor(_INVALID_ROW, dtype=torch.float32,
                         device=rows.device)
    rows = torch.where(valid[..., None], rows, inval)
    if layout == "field":
        rows = rows.transpose(1, 2)
    lo = torch.where(valid[..., None, None], tv, torch.inf).amin(dim=(1, 2))
    hi = torch.where(valid[..., None, None], tv, -torch.inf).amax(dim=(1, 2))
    aabbs = torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1)
    return (aabbs.float().contiguous(), rows.float().contiguous(), layout)


def _pad_boxes(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full((n, 3), FLT_MAX, dtype=like.dtype,
                                 device=like.device),
                      torch.full((n, 3), -FLT_MAX, dtype=like.dtype,
                                 device=like.device),
                      torch.zeros((n, 2), dtype=like.dtype,
                                  device=like.device)], dim=1)


def pad_cluster_stack(aabbs, tiles, padL: int, layout: str):
    """Append padL empty clusters (inverted boxes, all-invalid rows)."""
    inval = torch.tensor(_INVALID_ROW, dtype=tiles.dtype, device=tiles.device)
    if layout == "triangle":
        pad_t = inval.expand((padL,) + tiles.shape[1:])
    else:
        pad_t = inval[:, None].expand((padL,) + tiles.shape[1:])
    return (torch.cat([aabbs, _pad_boxes(padL, aabbs)]),
            torch.cat([tiles, pad_t]).contiguous())


def supercluster_boxes(aabbs, sc_n: int):
    """Union boxes of sc_n consecutive clusters [n_sc, 8]; empty members
    (lo = +inf, hi = -inf) vanish in the min / max."""
    lo = aabbs[:, 0:3].reshape(-1, sc_n, 3).amin(dim=1)
    hi = aabbs[:, 3:6].reshape(-1, sc_n, 3).amax(dim=1)
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1).contiguous()


def scene_exit_t(o, d, aabbs):
    """Per-ray exit t from the union of the cluster boxes, padded by 1e-4
    relative (boundary triangles lie on the union box, and the slab divide
    can round the exit an ulp below their plane t); -inf where the ray
    provably misses the box. Any hit has t <= exit, so the walk's stop
    bound tightens exactly to min(best, tmax, exit)."""
    u_lo = aabbs[:, 0:3].amin(dim=0)
    u_hi = aabbs[:, 3:6].amax(dim=0)
    nz = d != 0
    inv_d = torch.where(nz, 1.0 / torch.where(nz, d, 1.0), 0.0)
    t1 = torch.where(nz, (u_lo - o) * inv_d, -FLT_MAX)
    t2 = torch.where(nz, (u_hi - o) * inv_d, FLT_MAX)
    tnear = torch.minimum(t1, t2).amax(dim=1)
    tfar = torch.maximum(t1, t2).amin(dim=1)
    pad = tfar.abs() * 1e-4 + 1e-6
    return torch.where((tnear <= tfar + pad) & (tfar >= -pad), tfar + pad,
                       -torch.inf)


def pack_rays(o, d, tmax, exit_t, br: int):
    """[R] rays -> [NB, 8, BR] blocks (o, d, tmax, exit t). Pad rays are
    dead: tmax = -1, exit t = -FLT_MAX."""
    R = o.shape[0]
    pad = (-R) % br
    rows = torch.cat([o.T, d.T, tmax[None], exit_t[None]], dim=0)   # [8, R]
    if pad:
        fill = torch.zeros((8, pad), dtype=rows.dtype, device=rows.device)
        fill[6] = -1.0
        fill[7] = -FLT_MAX
        rows = torch.cat([rows, fill], dim=1)
    return rows.reshape(8, -1, br).transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# K1: block entry keys
# ---------------------------------------------------------------------------

def block_entry_keys_plain(rays, boxes, pairs_per_chunk: int = 1 << 24):
    """Plain twin of K1. rays [NB, 8, BR], boxes [S, 8] -> keys [NB, S]."""
    NB, _, BR = rays.shape
    S = boxes.shape[0]
    o, d, tm = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    nz = d != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, d, 1.0), 0.0)
    live = tm >= 0
    keys = torch.empty((NB, S), dtype=torch.float32, device=rays.device)
    kc = max(1, pairs_per_chunk // max(1, NB * BR))
    for s0 in range(0, S, kc):
        lo = boxes[s0:s0 + kc, 0:3]
        hi = boxes[s0:s0 + kc, 3:6]
        box_ok = (lo <= hi).all(dim=1)[None, :, None]
        tnear = tfar = None
        for ax in range(3):
            oo = o[:, ax, None, :]
            ii = inv[:, ax, None, :]
            nn = nz[:, ax, None, :]
            t1 = torch.where(nn, (lo[None, :, ax, None] - oo) * ii, -FLT_MAX)
            t2 = torch.where(nn, (hi[None, :, ax, None] - oo) * ii, FLT_MAX)
            a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tnear = a if tnear is None else torch.maximum(tnear, a)
            tfar = b if tfar is None else torch.minimum(tfar, b)
        geo = ((tnear <= tfar) & (tfar >= 0) & live[:, None, :]
               & (tnear <= tm[:, None, :]) & box_ok)
        entry = torch.where(geo, tnear.clamp_min(0.0), torch.inf)
        keys[:, s0:s0 + kc] = entry.amin(dim=2)
    return keys


def _check(t, name, dtype, ndim, device=None):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_rays(rays):
    _check(rays, "rays", torch.float32, 3)
    BR = rays.shape[2]
    if rays.shape[1] != 8 or BR % 32 or not 0 < BR <= 1024:
        raise ValueError(f"rays must be [NB, 8, BR] with BR a multiple of 32 "
                         f"up to 1024, got {tuple(rays.shape)}")


def block_entry_keys(rays, boxes):
    """K1: per-block box entry keys [NB, S]. rays [NB, 8, BR] (o, d, tmax,
    exit t), boxes [S, 8]. CPU tensors run the plain twin; CUDA tensors
    launch the kernel."""
    if rays.device.type == "cpu":
        return block_entry_keys_plain(rays, boxes)
    if rays.device.type != "cuda":
        raise ValueError(f"block_entry_keys: unsupported device {rays.device}")
    _check_rays(rays)
    _check(boxes, "boxes", torch.float32, 2, rays.device)
    if boxes.shape[1] != 8:
        raise ValueError(f"boxes must be [S, 8], got {tuple(boxes.shape)}")
    NB, _, BR = rays.shape
    S = boxes.shape[0]
    keys = torch.empty((NB, S), dtype=torch.float32, device=rays.device)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    lib.check(lib.cge_block_entry_keys(rays.data_ptr(), boxes.data_ptr(),
                                       keys.data_ptr(), NB, S, BR, stream),
              "cge_block_entry_keys")
    LAUNCHES["keys"] += 1
    return keys


# ---------------------------------------------------------------------------
# K2: ordered cluster walk
# ---------------------------------------------------------------------------

def _past(key, need):
    # inf > inf is False: the FLT_MAX test stops blocks whose next box no
    # live ray enters
    return (key > need) | (key >= FLT_MAX)


def cluster_walk_plain(order, skeys, rays, tiles, *, layout: str, sc_n: int,
                       any_hit: bool = False, shared_origin: bool = False):
    """Plain twin of K2: every block's walk at once, one visit per loop
    iteration. Returns (best_t [NB, BR], best_i [NB, BR] i32 flat
    perm-space slot or -1 (any-hit: 1 = blocked), visits [NB] i32)."""
    NB, _, BR = rays.shape
    n_sc = order.shape[1]
    dev = rays.device
    tri = tiles.transpose(1, 2) if layout == "field" else tiles   # [Lp, C, 16]
    C = tri.shape[1]
    tm, tm_eff = rays[:, 6], torch.minimum(rays[:, 6], rays[:, 7])
    live = tm >= 0
    bt = torch.full((NB, BR), torch.inf, dtype=torch.float32, device=dev)
    bi = torch.full((NB, BR), -1, dtype=torch.int32, device=dev)
    step = torch.zeros(NB, dtype=torch.int64, device=dev)
    need = torch.where(live, tm_eff, -torch.inf).amax(dim=1)
    stop = _past(skeys[:, 0], need)               # first-key guard
    slot = torch.arange(C, dtype=torch.int32, device=dev)
    while True:
        act = torch.nonzero(~stop)[:, 0]
        if act.numel() == 0:
            break
        r = rays[act]
        ox, oy, oz = r[:, 0, None], r[:, 1, None], r[:, 2, None]   # [A, 1, BR]
        dx, dy, dz = r[:, 3, None], r[:, 4, None], r[:, 5, None]
        tm_a = r[:, 6, None]
        bt_a, bi_a = bt[act], bi[act]
        sc = order[act, step[act]].long()
        for m in range(sc_n):
            cl = sc * sc_n + m
            T = tri[cl]                                             # [A, C, 16]

            def col(k):
                return T[:, :, k, None]                             # [A, C, 1]

            nx, ny, nz, D = col(0), col(1), col(2), col(3)
            dn = (dx * nx + dy * ny) + dz * nz
            if shared_origin:
                on = (r[:, 0, None, :1] * nx + r[:, 1, None, :1] * ny) \
                    + r[:, 2, None, :1] * nz
            else:
                on = (ox * nx + oy * ny) + oz * nz
            t = (D - on) / dn
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
            inside = None
            for k in range(3):
                e = ((px * col(4 * k + 4) - col(4 * k + 7)) + py * col(4 * k + 5)) \
                    + pz * col(4 * k + 6)
                inside = (e >= 0) if inside is None else inside & (e >= 0)
            ok = (t >= 0) & (t <= tm_a) & inside
            if any_hit:
                hit = ok.any(dim=1)
                bt_a = torch.where(hit, DONE, bt_a)
                bi_a = torch.where(hit, 1, bi_a)
            else:
                t = torch.where(ok, t, torch.inf)
                tmin = t.amin(dim=1)                                # [A, BR]
                flat = (cl[:, None].int() * C + slot)[:, :, None]   # [A, C, 1]
                idx = torch.where(t == tmin[:, None], flat, -1).amax(dim=1)
                take = (tmin <= bt_a) & torch.isfinite(tmin)
                bt_a = torch.where(take, tmin, bt_a)
                bi_a = torch.where(take, idx.int(), bi_a)
        bt[act], bi[act] = bt_a, bi_a
        step[act] += 1
        need = torch.where(live[act], torch.minimum(bt_a, tm_eff[act]),
                           -torch.inf).amax(dim=1)
        nxt = skeys[act, step[act].clamp_max(n_sc - 1)]
        stop[act] = (step[act] >= n_sc) | _past(nxt, need)
    return bt, bi, step.int()


def cluster_walk(order, skeys, rays, tiles, *, layout: str, sc_n: int,
                 any_hit: bool = False, shared_origin: bool = False):
    """K2: the ordered cluster walk. order [NB, n_sc] i32 and skeys [NB,
    n_sc] f32 (each block's sorted keys), rays [NB, 8, BR], tiles [Lp, C,
    16] or [Lp, 16, C] with Lp = n_sc * sc_n. Returns (best_t [NB, BR],
    best_i [NB, BR] i32, visits [NB] i32)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit,
              shared_origin=shared_origin)
    if rays.device.type == "cpu":
        return cluster_walk_plain(order, skeys, rays, tiles, **kw)
    if rays.device.type != "cuda":
        raise ValueError(f"cluster_walk: unsupported device {rays.device}")
    _check_rays(rays)
    dev = rays.device
    _check(order, "order", torch.int32, 2, dev)
    _check(skeys, "skeys", torch.float32, 2, dev)
    _check(tiles, "tiles", torch.float32, 3, dev)
    NB, _, BR = rays.shape
    n_sc = order.shape[1]
    C = tiles.shape[2] if layout == "field" else tiles.shape[1]
    fields = tiles.shape[1] if layout == "field" else tiles.shape[2]
    if (order.shape[0] != NB or skeys.shape != order.shape or fields != 16
            or tiles.shape[0] != n_sc * sc_n or n_sc == 0):
        raise ValueError(
            f"cluster_walk: shapes disagree: order {tuple(order.shape)}, "
            f"skeys {tuple(skeys.shape)}, rays {tuple(rays.shape)}, tiles "
            f"{tuple(tiles.shape)} ({layout}), sc_n {sc_n}")
    best_t = torch.empty((NB, BR), dtype=torch.float32, device=dev)
    best_i = torch.empty((NB, BR), dtype=torch.int32, device=dev)
    visits = torch.empty(NB, dtype=torch.int32, device=dev)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib.check(lib.cge_cluster_walk(
        order.data_ptr(), skeys.data_ptr(), rays.data_ptr(), tiles.data_ptr(),
        best_t.data_ptr(), best_i.data_ptr(), visits.data_ptr(),
        NB, n_sc, BR, sc_n, C, int(layout == "field"), int(any_hit),
        int(shared_origin), stream), "cge_cluster_walk")
    LAUNCHES["walk"] += 1
    return best_t, best_i, visits


# ---------------------------------------------------------------------------
# one sweep: pack, K1, sort, K2
# ---------------------------------------------------------------------------

def sweep_setup(o, d, tmax, aabbs, tiles, layout: str, br: int,
                sc_n: int | None):
    """Everything K1 and K2 take for one sweep: (rays, sc_aabbs, tiles,
    sc_n). Pads the stack to a multiple of sc_n clusters."""
    if sc_n is None:
        sc_n = SUPERCLUSTER if layout == "field" else 1
    L = tiles.shape[0]
    padL = (-L) % sc_n
    if padL:
        aabbs, tiles = pad_cluster_stack(aabbs, tiles, padL, layout)
    rays = pack_rays(o, d, tmax, scene_exit_t(o, d, aabbs), br)
    return rays, supercluster_boxes(aabbs, sc_n), tiles, sc_n


@torch.no_grad()
def cluster_tris(o, d, tmax, aabbs, tiles, layout: str, *,
                 br: int = DEFAULT_BR, sc_n: int | None = None,
                 any_hit: bool = False, shared_origin: bool = False):
    """Cluster-accelerated triangle sweep. o, d: [R, 3]; tmax: [R] per-ray
    budget (-1 = dead ray). Closest mode returns (best_t [R], flat [R] i32
    perm-space slot, -1 on miss, visits [NB]); any-hit mode returns
    (hit [R] bool, visits [NB]). sc_n None: 1 for the triangle-major
    layout, SUPERCLUSTER for field-major, as in the JAX package."""
    R = o.shape[0]
    rays, sc_boxes, tiles, sc_n = sweep_setup(o, d, tmax, aabbs, tiles,
                                              layout, br, sc_n)
    keys = block_entry_keys(rays, sc_boxes)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    bt, bi, visits = cluster_walk(order.int().contiguous(), skeys, rays, tiles,
                                  layout=layout, sc_n=sc_n, any_hit=any_hit,
                                  shared_origin=shared_origin)
    flat = bi.reshape(-1)[:R]
    if any_hit:
        return flat > 0, visits
    return bt.reshape(-1)[:R], flat, visits
