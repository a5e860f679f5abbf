"""The wavefront chain trace (counterpart of cge_tpu/render/wavefront.py:
52-463, 697-729).

The reference's per-pixel recursion (src/render.cpp:27-150) is affine in
each bounce's single child ray on every deterministic path:

    result = A * local + B * child_radiance

so the trace carries (origin, direction, weight, accumulator) for the whole
ray batch through a bounded loop of levels. Each level is one closest-hit
sweep, one gather of the packed attribute rows, Phong shading with one
any-hit shadow sweep per point light, and the mirror child ray. A level
whose rays are all dead is skipped, at the cost of one device sync.

The trace is differentiable: hit selection (the accel, the brute-force
table, both sweeps) runs under no_grad as a discrete oracle, and every
continuous quantity is recomputed from the ids with autograd, so gradients
flow scene -> attribute rows -> radiance.
"""

from __future__ import annotations

import dataclasses

import torch

from cge_tpu_torch.ops.interpolate import barycentric_coord, interpolate_normal
from cge_tpu_torch.ops.intersect import (Accel, HitIds, build_accel,
                                         closest_hit, triangle_plane,
                                         uses_cluster_sweep)
from cge_tpu_torch.ops.sweep import pack_tri_table
from cge_tpu_torch.ops.shading import _normalize, compute_reflection_ray
from cge_tpu_torch.render.lights import light_contribution
from cge_tpu_torch.types import check_supported


def _dot(a, b):
    return (a * b).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class HitAttrs:
    """Per-ray hit attributes (the reference's HitInfo + material fill,
    bounding_volume_hierarchy.cpp:369-424)."""

    hit: torch.Tensor           # [N] bool
    t: torch.Tensor             # [N] f32
    normal: torch.Tensor        # [N, 3]
    kd: torch.Tensor            # [N, 3]
    ks: torch.Tensor            # [N, 3]
    shininess: torch.Tensor     # [N]
    transparency: torch.Tensor  # [N]


# one [T, 40] row per triangle, so a level gathers once per ray:
# 0:9 v0 v1 v2 | 9:18 n0 n1 n2 | 18:24 kd ks | 24 shininess |
# 25 transparency | 26:32 uv0 uv1 uv2 | 32 tex_id | 33:40 pad
_ATTR_W = 40


def _take(x, idx):
    """x[idx] along dim 0 as index_select: its backward scatters with an
    atomic index_add_, where advanced indexing's backward accumulates
    repeated indices serially (every miss gathers row 0, every triangle
    one of a few materials)."""
    return x.index_select(0, idx)


def pack_attr_table(scene, tri_ids=None):
    """Per-triangle attribute rows [T, 40]. tri_ids: optional triangle ids
    giving the row order (the cluster permutation's flat slots, -1 pads
    allowed), so the sweep's perm-space hit ids index the rows directly."""
    T, mid = scene.tris, scene.tri_mat
    if tri_ids is not None:
        safe = tri_ids.reshape(-1).clamp_min(0)
        T, mid = T[safe], mid[safe]

    def corners(x):
        return [_take(x, T[:, k]) for k in range(3)]

    rows = torch.cat([*corners(scene.vertices), *corners(scene.normals),
                      _take(scene.mat_kd, mid), _take(scene.mat_ks, mid),
                      _take(scene.mat_shininess, mid)[:, None],
                      _take(scene.mat_transparency, mid)[:, None],
                      *corners(scene.uvs),
                      scene.mat_tex[mid][:, None].float()], dim=1)
    return torch.nn.functional.pad(rows, (0, _ATTR_W - rows.shape[1]))


def hit_attributes(scene, o, d, ids: HitIds, features,
                   attr_rows) -> HitAttrs:
    """Gather and recompute hit attributes from discrete hit ids.

    `ids.prim` is a triangle id in attr_rows' order (perm-space with the
    accel, scene order without) or a sphere index, so each
    gather clamps its index into its own table: a triangle slot can exceed
    the sphere table and a sphere index is meaningless in the row table.
    Clamping is what the JAX package's gathers do implicitly; the
    clamped rows are selected away by is_sphere."""
    if features.enable_texture_mapping:
        raise NotImplementedError("texture mapping: see ROADMAP 1.1")
    prim, is_sphere, hit = ids.prim, ids.is_sphere, ids.hit
    row = _take(attr_rows, prim.clamp(0, attr_rows.shape[0] - 1))  # [N, 40]
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n_geo, D = triangle_plane(v0, v1, v2)
    denom = _dot(d, n_geo)
    denom = torch.where(denom.abs() > 0, denom, 1.0)
    t_tri = (D - _dot(o, n_geo)) / denom

    sp = prim.clamp(0, scene.sph_center.shape[0] - 1)
    ctr = _take(scene.sph_center, sp)
    rad = _take(scene.sph_radius, sp)
    oc = o - ctr
    b = 2.0 * _dot(d, oc)
    c = _dot(oc, oc) - rad * rad
    disc = b * b - 4.0 * c
    disc_pos = disc > 0
    sq = torch.where(disc_pos, torch.sqrt(torch.where(disc_pos, disc, 1.0)),
                     0.0)
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t_sph = torch.where(t0 >= 0, t0, t1)

    t = torch.where(is_sphere, t_sph, t_tri)
    t = torch.where(hit, t, 0.0)
    p = o + t[:, None] * d

    if features.enable_normal_interp:
        bary = barycentric_coord(v0, v1, v2, p)
        n_i = interpolate_normal(row[:, 9:12], row[:, 12:15], row[:, 15:18],
                                 bary)
        n_tri = torch.where((_dot(n_i, d) > 0)[:, None], -n_i, n_i)  # flip
    else:
        n_tri = _normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
    normal = torch.where(is_sphere[:, None], _normalize(p - ctr), n_tri)

    smid = scene.sph_mat[sp]
    s1 = is_sphere[:, None]
    kd = torch.where(s1, _take(scene.mat_kd, smid), row[:, 18:21])
    ks = torch.where(s1, _take(scene.mat_ks, smid), row[:, 21:24])
    shininess = torch.where(is_sphere, _take(scene.mat_shininess, smid),
                            row[:, 24])
    transparency = torch.where(is_sphere,
                               _take(scene.mat_transparency, smid),
                               row[:, 25])
    return HitAttrs(hit=hit, t=t, normal=normal, kd=kd, ks=ks,
                    shininess=shininess, transparency=transparency)


def _intersect_and_shade(scene, o, d, features, params, alive, accel,
                         tri_table, shared_origin: bool, tables, ray_ids=None):
    """One bounce: closest hit, attributes, local radiance. Dead rays get
    tmax = -1, which the sweep treats as an unconditional miss."""
    tmax = torch.where(alive, torch.inf, -1.0)
    ids = closest_hit(scene, o, d, tmax, accel, tri_table=tri_table,
                      shared_origin=shared_origin and params.sweep_shared_origin,
                      br=params.sweep_br, sc_n=params.sweep_sc_n,
                      exact_keys=params.sweep_exact_keys,
                      sort_rays=bool(params.sweep_sort_bounce))
    attrs = hit_attributes(scene, o, d, ids, features, tables)
    local = light_contribution(scene, o, d, attrs.t, attrs.normal, attrs.kd,
                               attrs.ks, attrs.shininess, features, params,
                               alive=alive & attrs.hit, accel=accel,
                               tri_table=tri_table, ray_ids=ray_ids)
    return attrs, torch.where(attrs.hit[:, None], local, 0.0)


def _chain_coefficients(attrs: HitAttrs, depth_remaining: int, features):
    """Per-ray affine coefficients (A, B) of the single-child chain modes;
    derivation in cge_tpu.render.wavefront._chain_coefficients."""
    valid_mirror = (attrs.ks != 0.0).any(dim=-1)
    t_mat = attrs.transparency
    trans_ne1 = t_mat != 1.0
    if features.enable_recursive:
        g = 2.0 if depth_remaining >= 1 else 0.0
        g = torch.where(valid_mirror, g, 0.0)
        A = torch.where(trans_ne1, 1.0 - t_mat, 1.0)
        B = torch.where(trans_ne1, (1.0 - t_mat) * g + t_mat, g)
        return A, torch.where(valid_mirror, B, 0.0)
    if features.enable_transparency:
        cond = trans_ne1 & (depth_remaining > 0)
        return (torch.where(cond, t_mat, 1.0),
                torch.where(cond, 1.0 - t_mat, 0.0))
    return torch.ones_like(t_mat), torch.zeros_like(t_mat)


def _child_ray(o, d, attrs: HitAttrs, features):
    """The single child ray of the chain modes: the mirror ray, or the
    transparency continuation (render.cpp:42-43)."""
    if features.enable_recursive:
        ro, rd, _ = compute_reflection_ray(o, d, attrs.t, attrs.normal,
                                           attrs.ks)
        return ro, rd
    return (1e-5 + attrs.t)[:, None] * d + o, d


def _unroll_depth(scene, params, features) -> int:
    """Number of chain levels: ray_depth + 1 when recursive (plus the
    transparency quirk's extra levels for non-opaque scenes), ray_depth + 1
    for the depth-gated transparency continuation, else one."""
    if features.enable_recursive:
        base = params.ray_depth + 1
        return base if scene.all_opaque else (
            base + params.extra_transparency_unroll)
    if features.enable_transparency and not scene.all_opaque:
        return params.ray_depth + 1
    return 1


def trace_chain(scene, o, d, features, params, accel: Accel | None, tables,
                tri_table=None, shared_origin: bool = False, ray_ids=None):
    """Linear-chain trace over levels: [N, 3] radiance. Level 0 takes the
    shared-origin fast path when the caller promises one origin. accel /
    tri_table: what hit selection sweeps (ops.intersect.closest_hit)."""
    N = o.shape[0]
    acc = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
    W = torch.ones(N, dtype=torch.float32, device=o.device)
    alive = W != 0.0
    for level in range(_unroll_depth(scene, params, features)):
        if level > 0 and not bool(alive.any()):     # dead-level skip
            break
        attrs, local = _intersect_and_shade(
            scene, o, d, features, params, alive, accel, tri_table,
            shared_origin=shared_origin and level == 0, tables=tables,
            ray_ids=ray_ids)
        live_hit = alive & attrs.hit
        A, B = _chain_coefficients(attrs, params.ray_depth - level, features)
        co, cd = _child_ray(o, d, attrs, features)
        acc = acc + torch.where(live_hit[:, None], (W * A)[:, None] * local,
                                0.0)
        W = torch.where(live_hit, W * B, 0.0)
        alive = live_hit & (W != 0.0)
        o = torch.where(alive[:, None], co, o)
        d = torch.where(alive[:, None], cd, d)
    return acc


def scene_accel(scene, features) -> Accel | None:
    """The cluster accel, built only when the features ask for it and the
    scene has clusters; None sends hit selection to the brute-force sweep."""
    if features.enable_accel_structure and scene.cluster_perm is not None:
        return build_accel(scene)
    return None


def scene_tables(scene, accel: Accel | None):
    """Attribute rows in the id space closest_hit reports for this accel:
    perm-ordered for the cluster sweep, scene-ordered otherwise (the
    intersect.uses_cluster_sweep predicate)."""
    return pack_attr_table(
        scene, tri_ids=accel.perm if uses_cluster_sweep(accel) else None)


def scene_tri_table(scene, accel: Accel | None):
    """K3's packed triangle table when there is no accel, else None."""
    if uses_cluster_sweep(accel):
        return None
    return pack_tri_table(scene.vertices, scene.tris, scene.tri_mask)


def trace(scene, o, d, features, params, accel: Accel | None = None,
          tables=None, tri_table=None, shared_origin: bool = False,
          ray_ids=None):
    """Dispatch to the trace shape for the feature set; only the chain is
    ported. accel / tables / tri_table: prebuilt by
    renderer.prepare_render, or built here. Differentiable callers pass
    none of them, so the attribute rows are built inside the graph."""
    check_supported(features, params)
    if accel is None:
        accel = scene_accel(scene, features)
    if tables is None:
        tables = scene_tables(scene, accel)
    if tri_table is None:
        tri_table = scene_tri_table(scene, accel)
    return trace_chain(scene, o, d, features, params, accel, tables,
                       tri_table=tri_table, shared_origin=shared_origin,
                       ray_ids=ray_ids)
