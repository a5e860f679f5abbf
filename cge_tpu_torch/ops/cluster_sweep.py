"""Cluster-culled closest-hit / any-hit sweep
(counterpart of cge_tpu/ops/pallas/cluster_sweep.py:76-708).

Triangles are pre-permuted into clusters of CLUSTER_SIZE (ops.bvh), grouped
into superclusters of `sc_n` consecutive clusters. One sweep runs:

  1. the key pass: for every (ray block, supercluster) pair a lower bound
     of the entry t of the block's live rays. K1 (`block_entry_keys`, exact
     keys) takes the nearest live ray's entry; the frustum pass
     (`block_frustum_keys`, exact_keys=False) bounds it by interval
     arithmetic over the block's origin and direction hulls;
  2. a stable sort of each block's keys into its front-to-back visit order
     (`torch.sort`, in place of the JAX package's `lax.sort`);
  3. K2, the ordered walk: each ray block visits its superclusters in that
     order, tests every member cluster's triangles, and stops once the next
     key is behind every live ray's best t (`cluster_walk`). Two opt-in
     modes: `refine_members` re-culls each member cluster against the
     block's current best before its dense tile; `mxu` computes the dense
     tile's eight dot products as one contraction on the tensor cores
     (triangle layout only).

K1 and K2 are CUDA kernels (csrc/cluster_sweep.cu). K1 runs a block of
128 threads per (ray block, 128 boxes) over the block's live rays. K2's default walk and its refine_members mode run
each ray block as a thread block cluster (split_shape: CTAs per block,
lanes per ray) with the stop pipelined one visit ahead; the mxu mode runs
one block of one thread per ray. Beside each stands its
plain PyTorch twin (`block_entry_keys_plain`, `cluster_walk_plain`) with the
same visit order, stop bound, sentinels and tie rules. A wrapper runs the
twin for a tensor on the CPU and launches the kernel for a CUDA tensor;
there is no fallback between the two. `LAUNCHES` counts kernel launches by
mode, so a run can show that it went through the kernels.

Sentinels (as in the JAX package):
  - pad rays carry tmax = -1 and exit t = -FLT_MAX; a ray that provably
    misses the scene box has exit t = -inf;
  - empty clusters have lo = +inf, hi = -inf; pad clusters FLT_MAX/-FLT_MAX;
    both are inverted boxes, which no key pass enters;
  - any-hit marks a blocked ray with best t = -3e38 and flag 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cge_tpu_torch import _kernels

DEFAULT_BR = 512
SUPERCLUSTER = 4
# tile stacks above this size are packed field-major, as the JAX package
# does; the layout then also sets the default clusters per visit
RESIDENT_TILE_BYTES = 4 * 1024 * 1024
FLT_MAX = 3.4028234663852886e38
FLT_MIN = 1.1754943508222875e-38
DONE = -3.0e38                  # any-hit sentinel
LAYOUTS = ("triangle", "field")
# the mxu walk's block size limit (csrc/cluster_sweep.cu's MXU_MAX_BR)
MXU_MAX_BR = 512
# The default and refine walks' thread block clusters: (CTAs per ray
# block, lanes per ray), csrc/cluster_sweep.cu's compiled shapes in order
# of preference. A CTA runs BR / CTAs * lanes threads, at most
# SPLIT_MAX_THREADS. 8 x 16 was
# the fastest portable shape (clusters of up to 8 CTAs run on every Hopper
# part) at the main path's 16k-ray batches (tools/kernel_bench.py
# --shapes); 8 x 8 takes the blocks of 1024 rays.
SPLIT_SHAPES = ((8, 16), (8, 8))
SPLIT_MAX_THREADS = 1024

# b_i = 1 kills every edge test of a pad triangle
_INVALID_ROW = [0.0] * 4 + [0.0, 0.0, 0.0, 1.0] * 3

# launches by kernel and walk mode: K1; K2 default, refine_members, mxu
LAUNCHES = {"keys": 0, "walk": 0, "walk_refine": 0, "walk_mxu": 0}


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
# the key passes: K1 (exact keys) and the frustum bound
# ---------------------------------------------------------------------------

def _entry_slab(o, d, tm, lo, hi):
    """Clipped slab entry t of rays into boxes (the JAX package's
    _entry_slab, cluster_sweep.py:153-184): +inf where the ray misses the
    box, is dead (tm < 0) or enters past tm. o, d: 3-tuples of ray
    coordinates; lo, hi: 3-tuples of box coordinates that broadcast against
    them. A zero direction component passes its slab; inverted boxes (lo >
    hi on an axis: empty and pad clusters) never enter."""
    tnear = tfar = box_ok = None
    for ax in range(3):
        nz = d[ax] != 0
        inv = torch.where(nz, 1.0 / torch.where(nz, d[ax], 1.0), 0.0)
        t1 = torch.where(nz, (lo[ax] - o[ax]) * inv, -FLT_MAX)
        t2 = torch.where(nz, (hi[ax] - o[ax]) * inv, FLT_MAX)
        a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
        ok = lo[ax] <= hi[ax]
        tnear = a if tnear is None else torch.maximum(tnear, a)
        tfar = b if tfar is None else torch.minimum(tfar, b)
        box_ok = ok if box_ok is None else box_ok & ok
    geo = (tnear <= tfar) & (tfar >= 0) & (tm >= 0) & (tnear <= tm) & box_ok
    return torch.where(geo, tnear.clamp_min(0.0), torch.inf)


def block_entry_keys_plain(rays, boxes, pairs_per_chunk: int = 1 << 24):
    """Plain twin of K1. rays [NB, 8, BR], boxes [S, 8] -> keys [NB, S]."""
    NB, _, BR = rays.shape
    S = boxes.shape[0]
    o = [rays[:, ax, None, :] for ax in range(3)]           # [NB, 1, BR]
    d = [rays[:, 3 + ax, None, :] for ax in range(3)]
    tm = rays[:, 6, None, :]
    keys = torch.empty((NB, S), dtype=torch.float32, device=rays.device)
    kc = max(1, pairs_per_chunk // max(1, NB * BR))
    for s0 in range(0, S, kc):
        b = boxes[s0:s0 + kc]
        lo = [b[None, :, ax, None] for ax in range(3)]      # [1, k, 1]
        hi = [b[None, :, 3 + ax, None] for ax in range(3)]
        keys[:, s0:s0 + kc] = _entry_slab(o, d, tm, lo, hi).amin(dim=2)
    return keys


def block_frustum_keys(rays, boxes):
    """Conservative per-block entry keys [NB, S] by interval arithmetic
    (the JAX package's _block_frustum_keys, cluster_sweep.py:203-273).
    Each block is summarized by the hulls of its live rays' origins and
    directions, and the slab test runs once per (block, box) pair instead
    of once per (ray, box) pair. The key is a lower bound on every live
    ray's clipped entry t, so the walk's ordered stop stays exact; +inf
    where no live ray can enter. A plain torch op on every device: the
    JAX package computes it in XLA, outside any kernel.

    Where a direction interval spans 0, its zero endpoints are nudged to
    -/+FLT_MIN (huge, conservative candidates); an origin hull that may
    lie inside the slab then enters at -FLT_MAX, and the exit bound is
    +FLT_MAX either way."""
    o, d, tm = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    live = tm >= 0
    lv = live[:, None, :]
    ol = torch.where(lv, o, torch.inf).amin(dim=-1)          # [NB, 3]
    oh = torch.where(lv, o, -torch.inf).amax(dim=-1)
    dl = torch.where(lv, d, torch.inf).amin(dim=-1)
    dh = torch.where(lv, d, -torch.inf).amax(dim=-1)
    tmx = torch.where(live, tm, -torch.inf).amax(dim=-1)     # [NB]
    any_live = live.any(dim=-1)
    blo, bhi = boxes[:, 0:3], boxes[:, 3:6]
    box_ok = (blo <= bhi).all(dim=-1)                        # [S]
    tnear = tfar = None
    for ax in range(3):
        bl, bh = blo[None, :, ax], bhi[None, :, ax]          # [1, S]
        o0, o1 = ol[:, ax, None], oh[:, ax, None]            # [NB, 1]
        d0, d1 = dl[:, ax, None], dh[:, ax, None]
        n1a, n1b = bl - o1, bl - o0
        n2a, n2b = bh - o1, bh - o0
        spans0 = (d0 <= 0) & (d1 >= 0)
        safe0 = torch.where(d0 != 0, d0, -FLT_MIN)
        safe1 = torch.where(d1 != 0, d1, FLT_MIN)
        cands = [n1a / safe0, n1a / safe1, n1b / safe0, n1b / safe1,
                 n2a / safe0, n2a / safe1, n2b / safe0, n2b / safe1]
        lo_ax = hi_ax = cands[0]
        for c in cands[1:]:
            lo_ax = torch.minimum(lo_ax, c)
            hi_ax = torch.maximum(hi_ax, c)
        o_in_slab = (o1 >= bl) & (o0 <= bh)
        lo_ax = torch.where(spans0 & o_in_slab, -FLT_MAX, lo_ax)
        hi_ax = torch.where(spans0, FLT_MAX, hi_ax)
        tnear = lo_ax if tnear is None else torch.maximum(tnear, lo_ax)
        tfar = hi_ax if tfar is None else torch.minimum(tfar, hi_ax)
    maybe = ((tnear <= tfar) & (tfar >= 0) & (tnear <= tmx[:, None])
             & any_live[:, None] & box_ok[None, :])
    return torch.where(maybe, tnear.clamp_min(0.0), torch.inf)


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
    if boxes.data_ptr() % 16:
        raise ValueError("block_entry_keys: boxes must be 16-byte aligned")
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


def sort_keys(keys):
    """Each block's keys [NB, S] sorted stably, as lax.sort((keys, iota),
    num_keys=1) orders equal keys by box index: (skeys f32, order i32)."""
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    return skeys, order.int().contiguous()


def sweep_order(rays, boxes, exact_keys: bool = True):
    """Each block's visit order (skeys [NB, S] f32, order [NB, S] i32):
    the keys of K1 (exact_keys) or of the frustum bound, sorted."""
    return sort_keys(block_entry_keys(rays, boxes) if exact_keys
                     else block_frustum_keys(rays, boxes))


# ---------------------------------------------------------------------------
# K2: ordered cluster walk
# ---------------------------------------------------------------------------

WALK_MODES = {"default": "walk", "refine": "walk_refine", "mxu": "walk_mxu"}


def walk_mode(layout: str, refine_members: bool = False,
              mxu: bool = False) -> str:
    """The walk mode a call runs, by the JAX package's rules
    (cluster_sweep.py:472-476, 556-558): mxu acts on the triangle layout
    only and there takes precedence over refine_members."""
    if mxu and layout == "triangle":
        return "mxu"
    return "refine" if refine_members else "default"


def mxu_tiles(tiles):
    """Quantity-major repack of a triangle-major stack [Lp, C, 16] for the
    mxu walk (cluster_sweep.py:641-643): [Lp, 4C, 8], rows [0:C] = (n, D),
    [C:2C] = (m0, b0), [2C:3C] = (m1, b1), [3C:4C] = (m2, b2), each row
    zero-padded from 4 to 8 columns."""
    Lp, C, _ = tiles.shape
    q = tiles.reshape(Lp, C, 4, 4).transpose(1, 2).reshape(Lp, 4 * C, 4)
    return torch.nn.functional.pad(q, (0, 4)).contiguous()


def _past(key, need):
    # inf > inf is False: the FLT_MAX test stops blocks whose next box no
    # live ray enters
    return (key > need) | (key >= FLT_MAX)


def _tile_vpu(T, r, shared_origin):
    """The dense tile's t and edge tests [A, C, BR] in the hit-point form:
    t = (D - o.n) / d.n, p = o + t d, m_k.p - b_k >= 0."""
    def col(k):
        return T[:, :, k, None]                                 # [A, C, 1]

    ox, oy, oz = r[:, 0, None], r[:, 1, None], r[:, 2, None]    # [A, 1, BR]
    dx, dy, dz = r[:, 3, None], r[:, 4, None], r[:, 5, None]
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
    return t, inside


def _tile_mxu(Q, ray_ext):
    """The dense tile's t and edge tests [A, C, BR] in the two-dot form of
    the mxu mode (cluster_sweep.py:361-389): one contraction [A, 4C, 8] x
    [A, 8, 2BR] gives o.n - D, d.n, o.m_k - b_k and d.m_k; t = -(o.n - D)
    / d.n and each edge passes if (o.m_k - b_k) + t (d.m_k) >= 0. Pad rows
    give t = -0/0 = NaN, which every accept test rejects."""
    C, BR = Q.shape[1] // 4, ray_ext.shape[2] // 2
    out = torch.matmul(Q, ray_ext)                              # [A, 4C, 2BR]
    t = -out[:, :C, :BR] / out[:, :C, BR:]
    inside = None
    for k in range(1, 4):
        e = out[:, k * C:(k + 1) * C, :BR] \
            + t * out[:, k * C:(k + 1) * C, BR:] >= 0
        inside = e if inside is None else inside & e
    return t, inside


def _ray_ext(r):
    """[A, 8, 2BR]: o_ext = (ox, oy, oz, -1, 0, 0, 0, 0) in columns 0:BR,
    d_ext = (dx, dy, dz, 0, ...) in columns BR:2BR."""
    A, _, BR = r.shape
    z = torch.zeros((A, 4, BR), dtype=r.dtype, device=r.device)
    o_ext = torch.cat([r[:, 0:3], torch.full_like(r[:, :1], -1.0), z], dim=1)
    d_ext = torch.cat([r[:, 3:6], torch.zeros_like(r[:, :1]), z], dim=1)
    return torch.cat([o_ext, d_ext], dim=2)


def cluster_walk_plain(order, skeys, rays, tiles, *, layout: str, sc_n: int,
                       any_hit: bool = False, shared_origin: bool = False,
                       aabbs=None, refine_members: bool = False,
                       mxu: bool = False):
    """Plain twin of K2: every block's walk at once, one visit per loop
    iteration. Returns (best_t [NB, BR], best_i [NB, BR] i32 flat
    perm-space slot or -1 (any-hit: 1 = blocked), visits [NB] i32, dense
    tiles run [NB] i32). aabbs: the [Lp, 8] member boxes, needed by
    refine_members. The mxu contraction is a torch.matmul in f32 and
    wants TF32 off on a card (torch's default)."""
    mode = walk_mode(layout, refine_members, mxu)
    if mode == "refine" and aabbs is None:
        raise ValueError("refine_members needs the member boxes (aabbs)")
    NB, _, BR = rays.shape
    n_sc = order.shape[1]
    dev = rays.device
    tri = tiles.transpose(1, 2) if layout == "field" else tiles   # [Lp, C, 16]
    C = tri.shape[1]
    quant = mxu_tiles(tiles) if mode == "mxu" else None
    tm, tm_eff = rays[:, 6], torch.minimum(rays[:, 6], rays[:, 7])
    live = tm >= 0
    bt = torch.full((NB, BR), torch.inf, dtype=torch.float32, device=dev)
    bi = torch.full((NB, BR), -1, dtype=torch.int32, device=dev)
    step = torch.zeros(NB, dtype=torch.int64, device=dev)
    dense = torch.zeros(NB, dtype=torch.int32, device=dev)
    need = torch.where(live, tm_eff, -torch.inf).amax(dim=1)
    stop = _past(skeys[:, 0], need)               # first-key guard
    slot = torch.arange(C, dtype=torch.int32, device=dev)
    while True:
        act = torch.nonzero(~stop)[:, 0]
        if act.numel() == 0:
            break
        r = rays[act]
        tm_a = r[:, 6, None]
        ext = _ray_ext(r) if mode == "mxu" else None
        bt_a, bi_a = bt[act], bi[act]
        sc = order[act, step[act]].long()
        for m in range(sc_n):
            cl = sc * sc_n + m
            run = None
            if mode == "refine":
                # the member's slab entry against the block's current best;
                # dead lanes (entry = best = +inf) always vote to run
                box = aabbs[cl]                                     # [A, 8]
                entry = _entry_slab(
                    [r[:, k] for k in range(3)], [r[:, 3 + k] for k in range(3)],
                    r[:, 6], [box[:, k, None] for k in range(3)],
                    [box[:, 3 + k, None] for k in range(3)])        # [A, BR]
                run = (entry <= bt_a).any(dim=1)                    # [A]
            if mode == "mxu":
                t, inside = _tile_mxu(quant[cl], ext)
            else:
                t, inside = _tile_vpu(tri[cl], r, shared_origin)
            ok = (t >= 0) & (t <= tm_a) & inside
            if any_hit:
                hit = ok.any(dim=1)
                new_t = torch.where(hit, DONE, bt_a)
                new_i = torch.where(hit, 1, bi_a)
            else:
                t = torch.where(ok, t, torch.inf)
                tmin = t.amin(dim=1)                                # [A, BR]
                flat = (cl[:, None].int() * C + slot)[:, :, None]   # [A, C, 1]
                idx = torch.where(t == tmin[:, None], flat, -1).amax(dim=1)
                take = (tmin <= bt_a) & torch.isfinite(tmin)
                new_t = torch.where(take, tmin, bt_a)
                new_i = torch.where(take, idx.int(), bi_a)
            if run is None:
                bt_a, bi_a = new_t, new_i
                dense[act] += 1
            else:
                bt_a = torch.where(run[:, None], new_t, bt_a)
                bi_a = torch.where(run[:, None], new_i, bi_a)
                dense[act] += run.int()
        bt[act], bi[act] = bt_a, bi_a
        step[act] += 1
        need = torch.where(live[act], torch.minimum(bt_a, tm_eff[act]),
                           -torch.inf).amax(dim=1)
        nxt = skeys[act, step[act].clamp_max(n_sc - 1)]
        stop[act] = (step[act] >= n_sc) | _past(nxt, need)
    return bt, bi, step.int(), dense


def split_shape(br: int) -> tuple[int, int]:
    """The default walk's (CTAs per cluster, lanes per ray) for blocks of
    br rays: the first of SPLIT_SHAPES whose CTAs fit."""
    for cs, lanes in SPLIT_SHAPES:
        threads = br // cs * lanes
        if br % cs == 0 and threads % 32 == 0 and threads <= SPLIT_MAX_THREADS:
            return cs, lanes
    raise ValueError(f"no split walk shape fits blocks of {br} rays")


def cluster_walk(order, skeys, rays, tiles, *, layout: str, sc_n: int,
                 any_hit: bool = False, shared_origin: bool = False,
                 aabbs=None, refine_members: bool = False, mxu: bool = False,
                 _shape: tuple[int, int] | None = None):
    """K2: the ordered cluster walk. order [NB, n_sc] i32 and skeys [NB,
    n_sc] f32 (each block's sorted keys), rays [NB, 8, BR], tiles [Lp, C,
    16] or [Lp, 16, C] with Lp = n_sc * sc_n, aabbs [Lp, 8] (needed by
    refine_members). Returns (best_t [NB, BR], best_i [NB, BR] i32, visits
    [NB] i32, dense tiles run [NB] i32). The mode follows walk_mode; the
    default and refine walks launch a thread block cluster per ray block
    (split_shape), the mxu mode one block per ray block and needs C a
    multiple of 16 and BR <= MXU_MAX_BR. _shape forces one of SPLIT_SHAPES
    on the default and refine walks (tools/kernel_bench.py --shapes)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit,
              shared_origin=shared_origin, aabbs=aabbs,
              refine_members=refine_members, mxu=mxu)
    if rays.device.type == "cpu":
        return cluster_walk_plain(order, skeys, rays, tiles, **kw)
    if rays.device.type != "cuda":
        raise ValueError(f"cluster_walk: unsupported device {rays.device}")
    mode = walk_mode(layout, refine_members, mxu)
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
    if mode == "refine":
        if aabbs is None:
            raise ValueError("refine_members needs the member boxes (aabbs)")
        _check(aabbs, "aabbs", torch.float32, 2, dev)
        if tuple(aabbs.shape) != (tiles.shape[0], 8):
            raise ValueError(f"aabbs must be [{tiles.shape[0]}, 8], got "
                             f"{tuple(aabbs.shape)}")
    if mode == "mxu":
        if C % 16 or BR > MXU_MAX_BR:
            raise ValueError(f"the mxu walk needs C a multiple of 16 and BR "
                             f"<= {MXU_MAX_BR}, got C {C}, BR {BR}")
        tiles = mxu_tiles(tiles)
    best_t = torch.empty((NB, BR), dtype=torch.float32, device=dev)
    best_i = torch.empty((NB, BR), dtype=torch.int32, device=dev)
    visits = torch.empty(NB, dtype=torch.int32, device=dev)
    dense = torch.empty(NB, dtype=torch.int32, device=dev)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (best_t.data_ptr(), best_i.data_ptr(), visits.data_ptr(),
            dense.data_ptr())
    if mode == "mxu":
        lib.check(lib.cge_cluster_walk_mxu(
            order.data_ptr(), skeys.data_ptr(), rays.data_ptr(),
            tiles.data_ptr(), *outs, NB, n_sc, BR, sc_n, C, int(any_hit),
            stream), "cge_cluster_walk_mxu")
    else:
        refine = mode == "refine"
        if tiles.data_ptr() % 16 or (refine and aabbs.data_ptr() % 16):
            raise ValueError("cluster_walk: the tile stack and the member "
                             "boxes must be 16-byte aligned")
        cs, lanes = _shape or split_shape(BR)
        lib.check(lib.cge_cluster_walk_split(
            order.data_ptr(), skeys.data_ptr(), rays.data_ptr(),
            tiles.data_ptr(), aabbs.data_ptr() if refine else None, *outs,
            NB, n_sc, BR, sc_n, C, int(layout == "field"), int(any_hit),
            int(shared_origin), int(refine), cs, lanes, stream),
            "cge_cluster_walk_split")
    LAUNCHES[WALK_MODES[mode]] += 1
    return best_t, best_i, visits, dense


# ---------------------------------------------------------------------------
# one sweep: pack, key pass, sort, K2
# ---------------------------------------------------------------------------

class SweepInputs(NamedTuple):
    """What the key pass and K2 take for one sweep."""

    rays: torch.Tensor     # [NB, 8, BR] packed rays
    boxes: torch.Tensor    # [n_sc, 8] supercluster boxes
    tiles: torch.Tensor    # the stack padded to n_sc * sc_n clusters
    sc_n: int
    aabbs: torch.Tensor    # [n_sc * sc_n, 8] member boxes, padded alike


def sweep_setup(o, d, tmax, aabbs, tiles, layout: str, br: int,
                sc_n: int | None) -> SweepInputs:
    """Pack the rays and pad the stack to a multiple of sc_n clusters
    (None: 1 for the triangle layout, SUPERCLUSTER for the field layout,
    as in the JAX package)."""
    if sc_n is None:
        sc_n = SUPERCLUSTER if layout == "field" else 1
    L = tiles.shape[0]
    padL = (-L) % sc_n
    if padL:
        aabbs, tiles = pad_cluster_stack(aabbs, tiles, padL, layout)
    rays = pack_rays(o, d, tmax, scene_exit_t(o, d, aabbs), br)
    return SweepInputs(rays, supercluster_boxes(aabbs, sc_n), tiles, sc_n,
                       aabbs)


@torch.no_grad()
def sweep_blocks(o, d, tmax, aabbs, tiles, layout: str, *,
                 br: int = DEFAULT_BR, sc_n: int | None = None,
                 any_hit: bool = False, shared_origin: bool = False,
                 exact_keys: bool = True, refine_members: bool = False,
                 mxu: bool = False):
    """One sweep, reported per ray block: (best_t [NB, BR], best_i [NB,
    BR], visits [NB], dense tiles run [NB]); see cluster_tris."""
    inp = sweep_setup(o, d, tmax, aabbs, tiles, layout, br, sc_n)
    skeys, order = sweep_order(inp.rays, inp.boxes, exact_keys)
    return cluster_walk(order, skeys, inp.rays, inp.tiles, layout=layout,
                        sc_n=inp.sc_n, any_hit=any_hit,
                        shared_origin=shared_origin, aabbs=inp.aabbs,
                        refine_members=refine_members, mxu=mxu)


@torch.no_grad()
def cluster_tris(o, d, tmax, aabbs, tiles, layout: str, *,
                 br: int = DEFAULT_BR, sc_n: int | None = None,
                 any_hit: bool = False, shared_origin: bool = False,
                 exact_keys: bool = True, refine_members: bool = False,
                 mxu: bool = False):
    """Cluster-accelerated triangle sweep. o, d: [R, 3]; tmax: [R] per-ray
    budget (-1 = dead ray). Closest mode returns (best_t [R], flat [R] i32
    perm-space slot, -1 on miss, visits [NB]); any-hit mode returns
    (hit [R] bool, visits [NB]). sc_n None: 1 for the triangle-major
    layout, SUPERCLUSTER for field-major, as in the JAX package.
    exact_keys=False orders the visits by the frustum bound; refine_members
    and mxu select K2's opt-in modes (walk_mode)."""
    R = o.shape[0]
    bt, bi, visits, _ = sweep_blocks(
        o, d, tmax, aabbs, tiles, layout, br=br, sc_n=sc_n, any_hit=any_hit,
        shared_origin=shared_origin, exact_keys=exact_keys,
        refine_members=refine_members, mxu=mxu)
    flat = bi.reshape(-1)[:R]
    if any_hit:
        return flat > 0, visits
    return bt.reshape(-1)[:R], flat, visits
