"""Ray-primitive intersection (counterpart of cge_tpu/ops/intersect.py).

The reference's prebuilt intersection semantics (see the JAX module's
docstring): triangles accept 0 <= t <= ray.t with three edge sign tests, so
the later triangle wins an exact tie; spheres solve the quadratic with
a == 1 (unit direction assumed) and accept strictly t < ray.t, so a sphere
never displaces an equal-t triangle.

`closest_hit` and `any_hit_occlusion` take one of two triangle sweeps,
chosen by `uses_cluster_sweep`: with an `Accel`, the K1/K2 cluster sweep
(ops.cluster_sweep), which reports triangle hits as perm-space slots;
without one, the K3 brute-force sweep (ops.sweep) over the packed [T, 16]
table, which reports scene-order ids. Hit selection is a discrete oracle,
so everything here runs under `torch.no_grad()`; the continuous hit
quantities are recomputed from the ids by render.wavefront.hit_attributes.
"""

from __future__ import annotations

import dataclasses

import torch

from cge_tpu_torch.ops import cluster_sweep, sweep


def _dot(a, b):
    return (a * b).sum(dim=-1)


def triangle_plane(v0, v1, v2):
    """trianglePlane: n = normalize(cross(v1-v0, v2-v0)), D = dot(n, v0);
    degenerate triangles get n = 0."""
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    n2 = _dot(n, n)[..., None]
    pos = n2 > 0
    n = torch.where(pos, n / torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return n, _dot(n, v0)


def intersect_spheres_t(o, d, tmax, center, radius):
    """Batched ray x sphere with the a == 1 quirk. o, d: [R, 3]; tmax [R];
    center [S, 3]; radius [S]. Returns t [R, S], +inf on miss. Accept:
    disc >= 0, smallest non-negative root, t < tmax (strict)."""
    oc = o[:, None, :] - center[None, :, :]
    b = 2.0 * _dot(d[:, None, :], oc)
    c = _dot(oc, oc) - radius[None, :] ** 2
    disc = b * b - 4.0 * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = torch.where(t0 >= 0, t0, t1)
    ok = (disc >= 0) & (t >= 0) & (t < tmax[:, None])
    return torch.where(ok, t, torch.inf)


@dataclasses.dataclass(frozen=True)
class HitIds:
    """Discrete closest-hit result."""

    hit: torch.Tensor        # [R] bool
    t: torch.Tensor          # [R] f32, inf on miss
    is_sphere: torch.Tensor  # [R] bool
    prim: torch.Tensor       # [R] i64: perm-space triangle slot or sphere index


@dataclasses.dataclass(frozen=True)
class Accel:
    """The packed cluster stack, built once per scene and shared by every
    sweep. `layout` names the tile layout explicitly ("triangle": [L, C,
    16]; "field": [L, 16, C])."""

    perm: torch.Tensor     # [L, C] triangle ids, -1 pad
    aabbs: torch.Tensor    # [L, 8] cluster boxes (lo3, hi3, pad2)
    tiles: torch.Tensor    # packed triangle constants
    layout: str


@torch.no_grad()
def build_accel(scene, layout: str | None = None) -> Accel:
    """Pack the scene's clusters for the sweep."""
    aabbs, tiles, layout = cluster_sweep.pack_cluster_tiles(
        scene.vertices, scene.tris, scene.cluster_perm, layout)
    return Accel(perm=scene.cluster_perm, aabbs=aabbs, tiles=tiles,
                 layout=layout)


def uses_cluster_sweep(accel: Accel | None) -> bool:
    """The one predicate that decides both which triangle sweep
    closest_hit runs and the id space of its hits: perm-space slots from
    the cluster sweep, scene-order ids from the brute sweep. The renderer
    keys its attribute-row order off the same predicate
    (render.wavefront.scene_tables), so the two cannot drift."""
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


def _cluster_tris(accel: Accel, o, d, tmax, sort_rays: bool, **kw):
    """The cluster sweep over accel; with sort_rays it runs on
    coherent_sweep_order's permutation of the rays, and the per-ray
    results come back in the caller's order (visits stay per sorted
    block)."""
    if not sort_rays:
        return cluster_sweep.cluster_tris(o, d, tmax, accel.aabbs,
                                          accel.tiles, accel.layout, **kw)
    order, inv = coherent_sweep_order(o, d, tmax)
    *per_ray, visits = cluster_sweep.cluster_tris(
        o[order], d[order], tmax[order], accel.aabbs, accel.tiles,
        accel.layout, **kw)
    return (*(x[inv] for x in per_ray), visits)


def _sphere_hits(scene, o, d, budget):
    ts = intersect_spheres_t(o, d, budget, scene.sph_center,
                             scene.sph_radius)
    return torch.where(scene.sph_mask[None, :], ts, torch.inf)


@torch.no_grad()
def closest_hit(scene, o, d, tmax, accel: Accel | None = None, *,
                tri_table=None, shared_origin: bool = False, br: int = 512,
                sc_n: int | None = None, exact_keys: bool = True,
                sort_rays: bool = False) -> HitIds:
    """Closest hit over the scene's triangles and then its spheres, which
    test under the budget min(best_t, tmax) (ctor order,
    bounding_volume_hierarchy.cpp:158-171). With an accel the triangles go
    through the cluster sweep (perm-space ids); without one through K3
    over tri_table (scene-order ids), packed here when not given.
    shared_origin, br, sc_n, exact_keys and sort_rays tune the cluster
    sweep only. sort_rays runs it on coherent_sweep_order's permutation
    (without the shared-origin hoist, as the JAX package does); exact-t
    ties then resolve in the permuted visit order."""
    if uses_cluster_sweep(accel):
        best_t, best_i, _ = _cluster_tris(
            accel, o, d, tmax, sort_rays, br=br, sc_n=sc_n,
            exact_keys=exact_keys,
            shared_origin=shared_origin and not sort_rays)
    else:
        if tri_table is None:
            tri_table = sweep.pack_tri_table(scene.vertices, scene.tris,
                                             scene.tri_mask)
        best_t, best_i = sweep.closest_tris(
            o.contiguous(), d.contiguous(), tmax.contiguous(), tri_table)
    ts = _sphere_hits(scene, o, d, torch.minimum(best_t, tmax))
    ts_min, s_idx = ts.min(dim=1)       # first index among equal minima
    sphere_wins = torch.isfinite(ts_min)
    t = torch.where(sphere_wins, ts_min, best_t)
    hit = torch.isfinite(t)
    prim = torch.where(sphere_wins, s_idx, best_i.long())
    return HitIds(hit=hit, t=t, is_sphere=sphere_wins,
                  prim=torch.where(hit, prim, 0))


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
