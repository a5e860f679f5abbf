"""Ray-primitive intersection (counterpart of cge_tpu/ops/intersect.py).

The reference's prebuilt intersection semantics (see the JAX module's
docstring): triangles accept 0 <= t <= ray.t with three edge sign tests, so
the later triangle wins an exact tie; spheres solve the quadratic with
a == 1 (unit direction assumed) and accept strictly t < ray.t, so a sphere
never displaces an equal-t triangle.

The primitives (`triangle_plane`, `point_in_triangle`,
`intersect_ray_plane_t`, `intersect_triangles_t`, `intersect_spheres_t`,
`intersect_aabb`, `normalize`) are plain torch ops in ops/fp32.py's forms,
so the card and the CPU give the same bits; tests/
test_torch_intersect_golden.py holds them to the reference's compiled
library through tests/golden/golden_intersect.bin.

`closest_hit` and `any_hit_occlusion` take one of two triangle sweeps,
chosen by `uses_cluster_sweep`: with an `Accel`, the K1/K2 cluster sweep
(ops.cluster_sweep), which finds triangle hits as perm-space slots;
without one, the K3 brute-force sweep (ops.sweep) over the packed [T, 16]
table, which finds scene-order ids. `closest_hit` reports scene-order
triangle ids, as the JAX package does, unless `perm_ids` asks for the
slots (the renderer's attribute rows are in perm order). Hit selection is
a discrete oracle, so the sweeps run under `torch.no_grad()`; the
continuous hit quantities are recomputed from the ids by
render.wavefront.hit_attributes.

With `prims_axis` (inside a sharded entry point, cge_tpu_torch.parallel)
each rank of the axis sweeps a contiguous slice of the clusters or of the
packed table and reports global ids; the partial hits meet in one
all-gather over the axis and a tie-aware reduction (cge_tpu/ops/
intersect.py:355-409): the smallest t, and on equal t the largest global
id, in the space of the sweep (perm-space slots with the accel,
scene-order ids without); perm_ids then decides the reported space as on
one device.
"""

from __future__ import annotations

import dataclasses

import torch

from cge_tpu_torch.ops import cluster_sweep, fp32, sweep
from cge_tpu_torch.ops.cluster_sweep import FLT_MAX, FLT_MIN


def triangle_plane(v0, v1, v2):
    """trianglePlane: n = normalize(cross(v1-v0, v2-v0)), D = dot(n, v0);
    degenerate triangles get n = 0; fp32's cross and square root, so that
    every device rounds alike."""
    n = fp32.cross(v1 - v0, v2 - v0)
    n2 = fp32.dot3(n, n)[..., None]
    pos = n2 > 0
    n = torch.where(pos, n / fp32.sqrt_rn(torch.where(pos, n2, 1.0)), 0.0)
    return n, fp32.dot3(n, v0)


def intersect_spheres_t(o, d, tmax, center, radius):
    """Batched ray x sphere with the a == 1 quirk. o, d: [R, 3]; tmax [R];
    center [S, 3]; radius [S]. Returns t [R, S], +inf on miss. Accept:
    disc >= 0, smallest non-negative root, t < tmax (strict)."""
    oc = o[:, None, :] - center[None, :, :]
    b = 2.0 * fp32.dot3(d[:, None, :], oc)
    c = fp32.dot3(oc, oc) - radius[None, :] ** 2
    disc = b * b - 4.0 * c
    sq = fp32.sqrt_rn(disc.clamp_min(0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = torch.where(t0 >= 0, t0, t1)
    ok = (disc >= 0) & (t >= 0) & (t < tmax[:, None])
    return torch.where(ok, t, torch.inf)


def point_in_triangle(v0, v1, v2, n, p):
    """pointInTriangle: the three edge sign tests
    dot(cross(v_{i+1} - v_i, p - v_i), n) >= 0, all passing."""
    e0 = fp32.dot3(fp32.cross(v1 - v0, p - v0), n) >= 0
    e1 = fp32.dot3(fp32.cross(v2 - v1, p - v1), n) >= 0
    e2 = fp32.dot3(fp32.cross(v0 - v2, p - v2), n) >= 0
    return e0 & e1 & e2


def intersect_ray_plane_t(o, d, n, D):
    """intersectRayWithPlane's t = (D - n.o) / n.d, with no acceptance
    test."""
    return (D - fp32.dot3(n, o)) / fp32.dot3(n, d)


def intersect_triangles_t(o, d, tmax, v0, v1, v2):
    """Batched ray x triangle. o, d: [R, 3]; tmax [R]; v0, v1, v2: [T, 3].
    Returns t [R, T], +inf where rejected. Accept: 0 <= t <= tmax, the
    hit point inside, t finite. o.n and d.n are dot3's products (K3's
    form), where the JAX package takes HIGHEST-precision matmuls."""
    n, D = triangle_plane(v0, v1, v2)
    t = intersect_ray_plane_t(o[:, None], d[:, None], n[None], D[None])
    p = o[:, None] + t[..., None] * d[:, None]              # [R, T, 3]
    inside = point_in_triangle(v0[None], v1[None], v2[None], n[None], p)
    ok = (t >= 0) & (t <= tmax[:, None]) & inside & torch.isfinite(t)
    return torch.where(ok, t, torch.inf)


def slab_hit(o, d, lo, hi):
    """The compiled library's slab test with no budget, on operands that
    broadcast over their last axis of 3: (hit, t). A zero direction
    component takes the constants t_l = FLT_MIN, t_u = FLT_MAX, so a
    parallel ray passes that slab even from outside it. tnear < 0 (origin
    inside): hit iff tfar > 0, t = tfar; else hit iff tnear <= tfar,
    t = tnear; and t >= 0."""
    zero = d == 0
    safe_d = torch.where(zero, 1.0, d)
    t_l = torch.where(zero, FLT_MIN, (lo - o) / safe_d)
    t_u = torch.where(zero, FLT_MAX, (hi - o) / safe_d)
    tnear = torch.minimum(t_l, t_u).amax(dim=-1)
    tfar = torch.maximum(t_l, t_u).amin(dim=-1)
    inside = tnear < 0
    t = torch.where(inside, tfar, tnear)
    ok = torch.where(inside, tfar > 0, tnear <= tfar)
    return ok & (t >= 0), t


def intersect_aabb(o, d, tmax, lower, upper):
    """Batched ray x AABB (cge_tpu/ops/intersect.py:114): slab_hit with
    the reported t <= tmax. o, d: [R, 3]; tmax [R]; lower, upper: [B, 3].
    Returns (hit [R, B], t [R, B])."""
    hit, t = slab_hit(o[:, None], d[:, None], lower[None], upper[None])
    return hit & (t <= tmax[:, None]), t


def normalize(v, axis: int = -1):
    """v / |v| along axis, the squares summed in index order and the root
    rounded to nearest (ops/fp32.py), so every device gives the same bits;
    a zero vector gives NaN, as in the JAX package."""
    sq = (v * v).unbind(axis)
    s = sq[0]
    for x in sq[1:]:
        s = s + x
    return v / fp32.sqrt_rn(s).unsqueeze(axis)


@dataclasses.dataclass(frozen=True)
class HitIds:
    """Discrete closest-hit result."""

    hit: torch.Tensor        # [R] bool
    t: torch.Tensor          # [R] f32, inf on miss
    is_sphere: torch.Tensor  # [R] bool
    prim: torch.Tensor       # [R] i64: triangle id (scene order; the
    #                          perm-space slot under perm_ids with an
    #                          accel) or sphere index; 0 on a miss


@dataclasses.dataclass(frozen=True)
class Accel:
    """The packed cluster stack, built once per scene and shared by every
    sweep. `layout` names the tile layout explicitly ("triangle": [L, C,
    16]; "field": [L, 16, C]). `padded` holds the stack padded for each
    visit size a sweep asked for (padded_stack), built once."""

    perm: torch.Tensor     # [L, C] triangle ids, -1 pad
    aabbs: torch.Tensor    # [L, 8] cluster boxes (lo3, hi3, pad2)
    tiles: torch.Tensor    # packed triangle constants
    layout: str
    padded: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)


def padded_stack(accel: Accel, sc_n: int | None) -> tuple:
    """(aabbs, tiles, sc_n): accel's stack padded to a multiple of the
    visit's clusters (cluster_sweep.visit_clusters), as sweep_setup would
    pad it, built on the first sweep that asks and kept on the accel, so a
    sweep copies no stack and no host data."""
    sc_n = cluster_sweep.visit_clusters(accel.layout, sc_n)
    if sc_n not in accel.padded:
        padL = (-accel.tiles.shape[0]) % sc_n
        accel.padded[sc_n] = (cluster_sweep.pad_cluster_stack(
            accel.aabbs, accel.tiles, padL, accel.layout) if padL
            else (accel.aabbs, accel.tiles))
    return (*accel.padded[sc_n], sc_n)


@torch.no_grad()
def build_accel(scene, layout: str | None = None) -> Accel:
    """Pack the scene's clusters for the sweep."""
    aabbs, tiles, layout = cluster_sweep.pack_cluster_tiles(
        scene.vertices, scene.tris, scene.cluster_perm, layout)
    return Accel(perm=scene.cluster_perm, aabbs=aabbs, tiles=tiles,
                 layout=layout)


def uses_cluster_sweep(accel: Accel | None) -> bool:
    """The one predicate that decides both which triangle sweep
    closest_hit runs and the id space of its hits under perm_ids:
    perm-space slots from the cluster sweep, scene-order ids from the
    brute sweep. The renderer keys its attribute-row order off the same
    predicate (render.wavefront.scene_tables), so the two cannot
    drift."""
    return accel is not None


def coherent_sweep_order(point, d, tmax):
    """Sweep-local coherence permutation (cge_tpu/ops/intersect.py:178-213):
    live rays bucketed by direction octant (x*4 + y*2 + z on d > 0), dead
    rays (tmax < 0) last, stable within buckets. A 9-bucket counting
    permutation, as in the JAX package. Returns (order, inv) [N] i64:
    sorted slot j holds ray order[j], and ray i lands in slot inv[i].
    `point` is kept in the signature for future locality keys."""
    del point
    N = d.shape[0]
    pos_d = (d > 0).long()
    octant = pos_d[:, 0] * 4 + pos_d[:, 1] * 2 + pos_d[:, 2]
    bucket = torch.where(tmax >= 0, octant, 8)               # dead last
    onehot = (bucket[:, None] == torch.arange(9, device=d.device)).long()
    within = onehot.cumsum(dim=0) - 1                        # [N, 9]
    totals = onehot.sum(dim=0)
    offsets = totals.cumsum(dim=0) - totals                  # exclusive
    inv = within.gather(1, bucket[:, None])[:, 0] + offsets[bucket]
    order = torch.empty_like(inv)
    order[inv] = torch.arange(N, device=d.device)
    return order, inv


def _cluster_tris(accel: Accel, o, d, tmax, sort_rays: bool, sc_n=None,
                  **kw):
    """The cluster sweep over accel's padded_stack; with sort_rays it runs
    on coherent_sweep_order's permutation of the rays, and the per-ray
    results come back in the caller's order (visits stay per sorted
    block)."""
    aabbs, tiles, sc_n = padded_stack(accel, sc_n)
    if not sort_rays:
        return cluster_sweep.cluster_tris(o, d, tmax, aabbs, tiles,
                                          accel.layout, sc_n=sc_n, **kw)
    order, inv = coherent_sweep_order(o, d, tmax)
    *per_ray, visits = cluster_sweep.cluster_tris(
        o[order], d[order], tmax[order], aabbs, tiles, accel.layout,
        sc_n=sc_n, **kw)
    return (*(x[inv] for x in per_ray), visits)


def _sphere_hits(scene, o, d, budget):
    ts = intersect_spheres_t(o, d, budget, scene.sph_center,
                             scene.sph_radius)
    return torch.where(scene.sph_mask[None, :], ts, torch.inf)


def _prims_reduce(t, ids, axis):
    """All-gather (t, global id) over the prims axis in one collective and
    keep the smallest t, and among equal t the largest global id (JAX's
    rule, cge_tpu/ops/intersect.py:388-389 and :405-407)."""
    from cge_tpu_torch.parallel import comm

    both = comm.all_gather(torch.stack([t, ids.view(torch.float32)]),
                           axis.group)                       # [P, 2, R]
    ts, idx = both[:, 0], both[:, 1].contiguous().view(torch.int32)
    best_t = ts.amin(dim=0)
    best_i = torch.where(ts == best_t, idx, -1).amax(dim=0)
    return best_t, best_i


def _prims_cluster_tris(accel: Accel, o, d, tmax, axis, **kw):
    """The cluster sweep over this rank's slice of the stack, padded to
    ceil(L / P) * P clusters (pad_cluster_stack: inverted boxes, invalid
    rows, never hit), in perm-id mode; the slots turned global."""
    L, C = accel.perm.shape
    shard = -(-L // axis.size)
    lo = axis.index * shard
    hi = min(L, lo + shard)
    aabbs, tiles = accel.aabbs[lo:hi], accel.tiles[lo:hi]
    if hi - lo < shard:
        aabbs, tiles = cluster_sweep.pad_cluster_stack(
            aabbs, tiles, shard - max(0, hi - lo), accel.layout)
    t, slot, _ = cluster_sweep.cluster_tris(o, d, tmax, aabbs, tiles,
                                            accel.layout, **kw)
    return t, torch.where(slot >= 0, slot + lo * C, -1).to(torch.int32)


def _prims_brute_tris(o, d, tmax, tri_table, axis):
    """K3 over this rank's T / P rows of the packed table, ids global."""
    T = tri_table.shape[0]
    if T % axis.size:
        raise ValueError(f"{T} triangles do not split over the "
                         f"{axis.size} ranks of prims axis {axis.name!r}")
    shard = T // axis.size
    lo = axis.index * shard
    t, i = sweep.closest_tris(o, d, tmax, tri_table[lo:lo + shard])
    return t, torch.where(i >= 0, i + lo, -1).to(torch.int32)


@torch.no_grad()
def closest_hit(scene, o, d, tmax, accel: Accel | None = None, *,
                tri_table=None, shared_origin: bool = False, br: int = 512,
                sc_n: int | None = None, exact_keys: bool = True,
                sort_rays: bool = False, prims_axis: str | None = None,
                perm_ids: bool = False) -> HitIds:
    """Closest hit over the scene's triangles and then its spheres, which
    test under the budget min(best_t, tmax) (ctor order,
    bounding_volume_hierarchy.cpp:158-171). With an accel the triangles go
    through the cluster sweep, whose perm-space slots go back to scene
    triangle ids through accel.perm unless perm_ids keeps the slots (JAX's
    meaning, cge_tpu/ops/intersect.py:390-395); without one through K3
    over tri_table (scene-order ids, which perm_ids leaves alone), packed
    here when not given.
    shared_origin, br, sc_n, exact_keys and sort_rays tune the cluster
    sweep only. sort_rays runs it on coherent_sweep_order's permutation
    (without the shared-origin hoist, as the JAX package does); exact-t
    ties then resolve in the permuted visit order. prims_axis: the name
    of a bound mesh axis (parallel.comm) over which the triangles are
    sharded; the spheres then test replicated after the reduction, and
    sort_rays is not taken (the JAX package's rule)."""
    o, d, tmax = o.contiguous(), d.contiguous(), tmax.contiguous()
    if prims_axis is not None:
        from cge_tpu_torch.parallel import comm

        axis = comm.mesh_axis(prims_axis)
        if uses_cluster_sweep(accel):
            t, ids = _prims_cluster_tris(accel, o, d, tmax, axis, br=br,
                                         sc_n=sc_n, exact_keys=exact_keys,
                                         shared_origin=shared_origin)
        else:
            if tri_table is None:
                tri_table = sweep.pack_tri_table(scene.vertices, scene.tris,
                                                 scene.tri_mask)
            t, ids = _prims_brute_tris(o, d, tmax, tri_table, axis)
        best_t, best_i = _prims_reduce(t, ids, axis)
    elif uses_cluster_sweep(accel):
        best_t, best_i, _ = _cluster_tris(
            accel, o, d, tmax, sort_rays, br=br, sc_n=sc_n,
            exact_keys=exact_keys,
            shared_origin=shared_origin and not sort_rays)
    else:
        if tri_table is None:
            tri_table = sweep.pack_tri_table(scene.vertices, scene.tris,
                                             scene.tri_mask)
        best_t, best_i = sweep.closest_tris(o, d, tmax, tri_table)
    if uses_cluster_sweep(accel) and not perm_ids:
        slots = accel.perm.reshape(-1)
        best_i = torch.where(best_i >= 0, slots[best_i.clamp(
            0, slots.shape[0] - 1)], -1)
    ts = _sphere_hits(scene, o, d, torch.minimum(best_t, tmax))
    ts_min, s_idx = ts.min(dim=1)       # first index among equal minima
    sphere_wins = torch.isfinite(ts_min)
    t = torch.where(sphere_wins, ts_min, best_t)
    hit = torch.isfinite(t)
    prim = torch.where(sphere_wins, s_idx, best_i.long())
    return HitIds(hit=hit, t=t, is_sphere=sphere_wins,
                  prim=torch.where(hit, prim, 0))


def closest_hit_chunked(scene, o, d, tmax, ray_chunk: int = 2048, *,
                        accel: Accel | None = None,
                        shared_origin: bool = False, br: int = 512,
                        exact_keys: bool = True, perm_ids: bool = False,
                        sc_n: int | None = None, sort_rays: bool = False,
                        prims_axis: str | None = None) -> HitIds:
    """Memory-bounded closest hit (cge_tpu/ops/intersect.py:431-471). With
    an accel the whole batch goes through one closest_hit call: the ray
    blocks set K2's visit order and with it which of two exact-t hits
    wins, so the JAX package never chunks there. Without one the rays go
    through closest_hit in chunks of ray_chunk over one packed table, with
    the results of one call. The JAX package's tri_tile, prims_axis_size
    and use_pallas have no counterpart: K3 tiles the triangles itself,
    the axis size is the bound mesh's and the tensors' device picks the
    kernel."""
    kw = dict(shared_origin=shared_origin, br=br, exact_keys=exact_keys,
              perm_ids=perm_ids, sc_n=sc_n, sort_rays=sort_rays,
              prims_axis=prims_axis)
    if uses_cluster_sweep(accel):
        return closest_hit(scene, o, d, tmax, accel, **kw)
    table = sweep.pack_tri_table(scene.vertices, scene.tris, scene.tri_mask)
    parts = [closest_hit(scene, o[s:s + ray_chunk], d[s:s + ray_chunk],
                         tmax[s:s + ray_chunk], tri_table=table, **kw)
             for s in range(0, max(o.shape[0], 1), ray_chunk)]
    return HitIds(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(HitIds)})


@torch.no_grad()
def any_hit_occlusion(scene, o, d, tmax, accel: Accel | None = None, *,
                      tri_table=None, br: int = 512, tri_rays=None,
                      sc_n: int | None = None, exact_keys: bool = True,
                      sort_rays: bool = False):
    """True where any primitive blocks the ray within its budget.

    With an accel this is the cluster sweep's any-hit mode. tri_rays:
    optional (o2, d2), another parameterization of the same segments used
    only for that triangle sweep (the shadow path passes the budget-1 query
    reversed from the light). Triangle acceptance is invariant under that
    reversal; the sphere quadratic's a == 1 quirk is not, so spheres always
    test the forward (o, d). Without an accel the query is the forward
    closest hit (K3), as in the JAX package, and tri_rays is not used.
    sort_rays permutes the triangle query by coherent_sweep_order, whose
    key is the query's direction and liveness."""
    if not uses_cluster_sweep(accel):
        return closest_hit(scene, o, d, tmax, tri_table=tri_table).hit
    to, td = tri_rays if tri_rays is not None else (o, d)
    tri_hit, _ = _cluster_tris(accel, to, td, tmax, sort_rays, br=br,
                               sc_n=sc_n, any_hit=True, exact_keys=exact_keys)
    ts = _sphere_hits(scene, o, d, tmax)
    return tri_hit | torch.isfinite(ts.amin(dim=1))
