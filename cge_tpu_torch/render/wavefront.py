"""The wavefront trace (counterpart of cge_tpu/render/wavefront.py).

The reference's per-pixel recursion (src/render.cpp:27-150) is affine in
each bounce's single child ray on every deterministic path:

    result = A * local + B * child_radiance

so the trace carries (origin, direction, weight, accumulator) for the whole
ray batch through a bounded loop of levels. Each level is one closest-hit
sweep, one gather of the packed attribute rows (and of the texels, with
texture mapping), Phong shading with one shadow sweep per point light and
one batched sweep over the samples of each segment or parallelogram light,
and the child rays. Level l draws its light samples from fold_in(key, l).
A level whose rays are all dead is skipped, at the cost of one device
sync. Two shapes are not a chain: with transparency and recursion both on,
the mirror and the continuation children fold into the ray axis
(trace_tree_trans_recursive); with glossy reflections the first bounce
fans out a cone of samples (trace_glossy).

The trace is differentiable: hit selection (the accel, the brute-force
table, both sweeps) runs under no_grad as a discrete oracle, and every
continuous quantity is recomputed from the ids with autograd, so gradients
flow scene -> attribute rows -> radiance.
"""

from __future__ import annotations

import dataclasses

import torch

from cge_tpu_torch.ops import fp32, rng
from cge_tpu_torch.ops.interpolate import (barycentric_coord,
                                           interpolate_normal,
                                           interpolate_texcoord)
from cge_tpu_torch.ops.intersect import (Accel, HitIds, build_accel,
                                         closest_hit, triangle_plane,
                                         uses_cluster_sweep)
from cge_tpu_torch.ops.sweep import pack_tri_table
from cge_tpu_torch.ops.shading import _normalize, compute_reflection_ray
from cge_tpu_torch.ops.texture import acquire_texel
from cge_tpu_torch.render import graphs
from cge_tpu_torch.render.lights import light_contribution
from cge_tpu_torch.types import check_supported


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
    prim, is_sphere, hit = ids.prim, ids.is_sphere, ids.hit
    row = _take(attr_rows, prim.clamp(0, attr_rows.shape[0] - 1))  # [N, 40]
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n_geo, D = triangle_plane(v0, v1, v2)
    denom = fp32.dot3(d, n_geo)
    denom = torch.where(denom.abs() > 0, denom, 1.0)
    t_tri = (D - fp32.dot3(o, n_geo)) / denom

    sp = prim.clamp(0, scene.sph_center.shape[0] - 1)
    ctr = _take(scene.sph_center, sp)
    rad = _take(scene.sph_radius, sp)
    oc = o - ctr
    b = 2.0 * fp32.dot3(d, oc)
    c = fp32.dot3(oc, oc) - rad * rad
    disc = b * b - 4.0 * c
    disc_pos = disc > 0
    sq = torch.where(disc_pos, fp32.sqrt_rn(torch.where(disc_pos, disc, 1.0)),
                     0.0)
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t_sph = torch.where(t0 >= 0, t0, t1)

    t = torch.where(is_sphere, t_sph, t_tri)
    t = torch.where(hit, t, 0.0)
    p = o + t[:, None] * d

    bary = (barycentric_coord(v0, v1, v2, p) if features.enable_normal_interp
            or features.enable_texture_mapping else None)
    if features.enable_normal_interp:
        n_i = interpolate_normal(row[:, 9:12], row[:, 12:15], row[:, 15:18],
                                 bary)
        n_tri = torch.where((fp32.dot3(n_i, d) > 0)[:, None], -n_i, n_i)  # flip
    else:
        n_tri = _normalize(fp32.cross(v1 - v0, v2 - v0))
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

    if features.enable_texture_mapping:           # bvh cpp:409-417
        tex_id = torch.where(is_sphere, scene.mat_tex[smid],
                             row[:, 32].detach().to(torch.int64))
        uv = interpolate_texcoord(row[:, 26:28], row[:, 28:30],
                                  row[:, 30:32], bary)
        texel = acquire_texel(scene.textures, scene.tex_hw, tex_id, uv,
                              features.enable_bilinear_texture_filtering)
        use_tex = (tex_id >= 0) & ~is_sphere
        kd = torch.where(use_tex[:, None], texel, kd)
    return HitAttrs(hit=hit, t=t, normal=normal, kd=kd, ks=ks,
                    shininess=shininess, transparency=transparency)


def _intersect_and_shade(scene, o, d, features, params, alive, accel,
                         tri_table, shared_origin: bool, tables, key,
                         ray_ids=None):
    """One bounce: closest hit, attributes, local radiance. Dead rays get
    tmax = -1, which the sweep treats as an unconditional miss. key: the
    level's key for the light samples. On the card with gradients off and
    no prims axis it runs as a CUDA graph replay (render.graphs), whose
    outputs a later bounce may overwrite: callers consume them before the
    next bounce."""
    args = (scene, o, d, features, params, alive, accel, tri_table,
            shared_origin, tables, key, ray_ids)
    if graphs.applies(o, params):
        return graphs.bounce(_bounce, *args)
    return _bounce(*args)


def _bounce(scene, o, d, features, params, alive, accel, tri_table,
            shared_origin, tables, key, ray_ids):
    """_intersect_and_shade's eager body."""
    tmax = torch.where(alive, torch.inf, -1.0)
    ids = closest_hit(scene, o, d, tmax, accel, tri_table=tri_table,
                      shared_origin=shared_origin and params.sweep_shared_origin,
                      br=params.sweep_br, sc_n=params.sweep_sc_n,
                      exact_keys=params.sweep_exact_keys,
                      sort_rays=bool(params.sweep_sort_bounce),
                      prims_axis=params.prims_axis, perm_ids=True)
    attrs = hit_attributes(scene, o, d, ids, features, tables)
    local = light_contribution(scene, o, d, attrs.t, attrs.normal, attrs.kd,
                               attrs.ks, attrs.shininess, features, params,
                               key, alive=alive & attrs.hit,
                               accel=accel, tri_table=tri_table,
                               ray_ids=ray_ids)
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


def _run_chain(scene, o, d, W, features, params, accel, tables, key,
               levels: range, tail_trans: bool = False, tri_table=None,
               shared_origin: bool = False, ray_ids=None):
    """The affine chain over `levels`, from weights W ([N]; None: every
    ray live with weight 1): [N, 3] radiance (_scan_chain,
    cge_tpu/render/wavefront.py:346-446). Level l draws its light samples
    from fold_in(key, l); the first level takes the shared-origin fast
    path when the caller promises one origin. tail_trans selects the TRANS+
    REC tree's tail coefficients (A = 1 - t, B = t on t != 1, the
    continuation child: render.cpp:122-130 with the depth gates closed). A
    level whose rays are all dead is skipped, and so is every later one:
    they would add exact zeros."""
    N = o.shape[0]
    acc = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
    fresh = W is None
    if fresh:
        W = torch.ones(N, dtype=torch.float32, device=o.device)
    alive = W != 0.0
    for level in levels:
        if not (fresh and level == levels.start) and not bool(alive.any()):
            break
        attrs, local = _intersect_and_shade(
            scene, o, d, features, params, alive, accel, tri_table,
            shared_origin=shared_origin and level == levels.start,
            tables=tables, key=rng.fold_in(key, level), ray_ids=ray_ids)
        live_hit = alive & attrs.hit
        if tail_trans:
            trans_ne1 = attrs.transparency != 1.0
            A = torch.where(trans_ne1, 1.0 - attrs.transparency, 1.0)
            B = torch.where(trans_ne1, attrs.transparency, 0.0)
            co, cd = (1e-5 + attrs.t)[:, None] * d + o, d
        else:
            A, B = _chain_coefficients(attrs, params.ray_depth - level,
                                       features)
            co, cd = _child_ray(o, d, attrs, features)
        acc = acc + torch.where(live_hit[:, None], (W * A)[:, None] * local,
                                0.0)
        W = torch.where(live_hit, W * B, 0.0)
        alive = live_hit & (W != 0.0)
        o = torch.where(alive[:, None], co, o)
        d = torch.where(alive[:, None], cd, d)
    return acc


def trace_chain(scene, o, d, features, params, accel: Accel | None, tables,
                key, tri_table=None, shared_origin: bool = False,
                ray_ids=None):
    """Linear-chain trace (every mode but TRANS+REC and glossy): [N, 3]
    radiance over _unroll_depth levels from level 0. accel / tri_table:
    what hit selection sweeps (ops.intersect.closest_hit)."""
    return _run_chain(scene, o, d, None, features, params, accel, tables,
                      key, range(_unroll_depth(scene, params, features)),
                      tri_table=tri_table, shared_origin=shared_origin,
                      ray_ids=ray_ids)


def trace_tree_trans_recursive(scene, o, d, features, params,
                               accel: Accel | None, tables, key,
                               tri_table=None, shared_origin: bool = False,
                               ray_ids=None):
    """TRANS + REC (glossy off): two children per bounce folded into the
    ray axis (cge_tpu/render/wavefront.py:466-561; the derivation of the
    weights is there). For a hit of transparency t:

        A = 1 - t on t != 1, else 1   (local)
        wM = A * [ks != 0]            (the mirror child)
        wS = A + t on t != 1, else [ks != 0]   (the second child: the
             continuation on t != 1, the mirror again on t == 1)

    Level l < ray_depth traces N * 2^l rays, children concatenated as
    [mirror; second] with global ids 2i and 2i + 1, so the soft-shadow
    streams do not depend on the chunking; radiance folds back onto the
    N parents with reshape(-1, N, 3).sum(0). Level 0 runs with every ray
    live and takes the shared-origin fast path. The 2^ray_depth leaves then
    run the ungated t != 1 continuation tail from level ray_depth. With
    scene.all_diffuse (ks == 0 everywhere) every mirror child is the dead
    zero sentinel, so only the second child is kept, with id 2i + 1: the
    same radiance. Once every ray of a level is dead the rest would add
    exact zeros, so it is skipped."""
    N = o.shape[0]
    acc = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
    cw = torch.ones(N, dtype=torch.float32, device=o.device)
    ids = (torch.arange(N, dtype=torch.int64, device=o.device)
           if ray_ids is None else ray_ids)
    for level in range(params.ray_depth):
        alive = cw != 0.0
        if level > 0 and not bool(alive.any()):
            return acc
        attrs, local = _intersect_and_shade(
            scene, o, d, features, params, alive, accel, tri_table,
            shared_origin=shared_origin and level == 0, tables=tables,
            key=rng.fold_in(key, level), ray_ids=ids)
        live_hit = alive & attrs.hit
        t_mat = attrs.transparency
        trans_ne1 = t_mat != 1.0
        g1 = torch.where((attrs.ks != 0.0).any(dim=-1), 1.0, 0.0)
        mo, md, _ = compute_reflection_ray(o, d, attrs.t, attrs.normal,
                                           attrs.ks)
        cono = (1e-5 + attrs.t)[:, None] * d + o      # the continuation
        so = torch.where(trans_ne1[:, None], cono, mo)
        sd = torch.where(trans_ne1[:, None], d, md)
        g2 = torch.where(trans_ne1, 1.0, g1)
        A = torch.where(trans_ne1, 1.0 - t_mat, 1.0)
        wS = torch.where(trans_ne1, A * g2 + t_mat, g2)
        contrib = torch.where(live_hit[:, None], (cw * A)[:, None] * local,
                              0.0)
        acc = acc + contrib.reshape(-1, N, 3).sum(dim=0)
        if scene.all_diffuse:
            o, d = so, sd
            cw = torch.where(live_hit, cw * wS, 0.0)
            ids = ids * 2 + 1
        else:
            o, d = torch.cat([mo, so]), torch.cat([md, sd])
            cw = torch.cat([torch.where(live_hit, cw * (A * g1), 0.0),
                            torch.where(live_hit, cw * wS, 0.0)])
            ids = torch.cat([ids * 2, ids * 2 + 1])
    tail = _unroll_depth(scene, params, features) - params.ray_depth
    tail_acc = _run_chain(scene, o, d, cw, features, params, accel, tables,
                          key, range(params.ray_depth,
                                     params.ray_depth + tail),
                          tail_trans=True, tri_table=tri_table, ray_ids=ids)
    return acc + tail_acc.reshape(-1, N, 3).sum(dim=0)


def _orthonormal_cone_basis(w):
    """The min-component basis (render.cpp:57-71): t = w with its first
    minimum component set to 1, u = normalize(t x w), v = w x u. Returns
    (u, v, ok): where t x w vanishes (w = 0, the zero mirror sentinel of
    ks == 0) ok is false and u = v = 0; the JAX package divides 0 by 0
    there, and its sample directions come out 0 all the same."""
    first_min = torch.nn.functional.one_hot(torch.argmin(w, dim=-1), 3)
    t = torch.where(first_min.bool(), 1.0, w)
    u = fp32.cross(t, w)
    n2 = fp32.dot3(u, u)[:, None]
    ok = n2 > 0
    u = torch.where(ok, u / fp32.sqrt_rn(torch.where(ok, n2, 1.0)), 0.0)
    return u, fp32.cross(w, u), ok[:, 0]


def _glossy_sample_dirs(attrs: HitAttrs, md, n_samples: int, params, key,
                        ray_ids):
    """Cone sample directions (render.cpp:84-90) about the mirror
    direction md: (dirs [N, S, 3], above [N, S]), the jitter drawn from
    each ray's streams fold_in(key, 0) and fold_in(key, 1)."""
    w = _normalize(md)
    u, v, ok = _orthonormal_cone_basis(w)
    sh = attrs.shininess
    a = (torch.ones_like(sh) / torch.where(sh != 0, sh, 1.0)
         * params.alpha_modifier)[:, None]
    r1 = rng.per_ray_uniform(rng.fold_in(key, 0), ray_ids, (n_samples,))
    r2 = rng.per_ray_uniform(rng.fold_in(key, 1), ray_ids, (n_samples,))
    wu = (-a / 2.0 + r1 * a)[..., None]
    wv = (-a / 2.0 + r2 * a)[..., None]
    dirs = _normalize(w[:, None, :] + wu * u[:, None, :] + wv * v[:, None, :])
    dirs = torch.where(ok[:, None, None], dirs, 0.0)
    return dirs, fp32.dot3(attrs.normal[:, None, :], dirs) > 0


def trace_glossy(scene, o, d, features, params, accel: Accel | None, tables,
                 key, tri_table=None, shared_origin: bool = False,
                 ray_ids=None):
    """Glossy reflections (render.cpp:56-99; cge_tpu/render/wavefront.py:
    594-694): the first bounce fans out rays_per_reflection (S) cone
    samples into the ray axis, sample s of ray i with id i * S + s, each
    weighted ks / S where it leaves above the surface; shininess-0
    materials take the plain mirror, with full weight on sample 0. Then
    ray_depth levels trace one cone sample a ray with per-ray vec3 weights
    and depth: min(depth - 1, glossy_reflections_cap) after a glossy
    bounce, depth - 1 after a mirror. Keys: fold_in(key, 0) shades the
    first bounce and fold_in(fold_in(key, 0), 100) draws its cone; level
    l uses fold_in(key, 1000 + l) and its cone fold_in(that, 5). A level
    whose weights are all zero ends the loop: it and every later level
    would change nothing."""
    N, S, dev = o.shape[0], params.rays_per_reflection, o.device
    if ray_ids is None:
        ray_ids = torch.arange(N, dtype=torch.int64, device=dev)
    k0 = rng.fold_in(key, 0)
    attrs, local = _intersect_and_shade(
        scene, o, d, features, params, torch.ones(N, dtype=torch.bool,
                                                  device=dev),
        accel, tri_table, shared_origin=shared_origin, tables=tables,
        key=k0, ray_ids=ray_ids)
    # read after the level loop's bounces, which may overwrite a graph's
    # outputs
    local, hit0 = local.clone(), attrs.hit.clone()
    valid_mirror = (attrs.ks != 0.0).any(dim=-1)
    glossy = (valid_mirror & (attrs.shininess != 0.0))[:, None, None]
    mo, md, _ = compute_reflection_ray(o, d, attrs.t, attrs.normal, attrs.ks)
    gdirs, above = _glossy_sample_dirs(attrs, md, S, params,
                                       rng.fold_in(k0, 100), ray_ids)
    w_glossy = fp32.div(torch.where(above[..., None], attrs.ks[:, None, :],
                                    0.0), float(S))
    w_plain = (torch.arange(S, device=dev) == 0).float()[None, :, None]
    spawn = (valid_mirror & attrs.hit & (params.ray_depth >= 1))
    W = torch.where(spawn[:, None, None],
                    torch.where(glossy, w_glossy, w_plain), 0.0)
    depth = torch.where(glossy[:, 0, 0],
                        min(params.ray_depth - 1,
                            params.glossy_reflections_cap),
                        params.ray_depth - 1)[:, None].expand(N, S)
    ids = (ray_ids[:, None] * S
           + torch.arange(S, dtype=torch.int64, device=dev)).reshape(-1)
    fo = mo[:, None, :].expand(N, S, 3).reshape(-1, 3)
    fd = torch.where(glossy, gdirs, md[:, None, :]).reshape(-1, 3)
    W, depth = W.reshape(-1, 3), depth.reshape(-1)
    acc = torch.zeros((N * S, 3), dtype=torch.float32, device=dev)
    cap = params.glossy_reflections_cap
    for level in range(params.ray_depth):
        live_in = (W != 0.0).any(dim=-1)
        if not bool(live_in.any()):
            break
        k = rng.fold_in(key, 1000 + level)
        at, lo = _intersect_and_shade(
            scene, fo, fd, features, params, live_in, accel, tri_table,
            shared_origin=False, tables=tables, key=k, ray_ids=ids)
        alive = live_in & at.hit
        acc = acc + torch.where(alive[:, None], W * lo, 0.0)
        vm = (at.ks != 0.0).any(dim=-1)
        ga = vm & (at.shininess != 0.0)
        mo, md, _ = compute_reflection_ray(fo, fd, at.t, at.normal, at.ks)
        gdir, abv = _glossy_sample_dirs(at, md, 1, params,
                                        rng.fold_in(k, 5), ids)
        spawn = alive & vm & (depth >= 1)
        step = torch.where(ga[:, None],
                           torch.where(abv[:, 0][:, None], at.ks, 0.0), 1.0)
        W = torch.where(spawn[:, None], W * step, 0.0)
        depth = torch.where(ga, torch.clamp(depth - 1, max=cap), depth - 1)
        fo = torch.where(spawn[:, None], mo, fo)
        fd = torch.where(spawn[:, None],
                         torch.where(ga[:, None], gdir[:, 0], md), fd)
    radiance = local + acc.reshape(N, S, 3).sum(dim=1)
    return torch.where(hit0[:, None], radiance, 0.0)


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


def trace(scene, o, d, features, params, key,
          accel: Accel | None = None, tables=None, tri_table=None,
          shared_origin: bool = False, ray_ids=None):
    """Dispatch to the trace shape for the feature set, as the JAX package
    does (cge_tpu/render/wavefront.py:697-729): glossy with recursion, the
    TRANS+REC tree, else the chain. key: the trace's key (ops.rng; the JAX
    package's `key`). accel / tables / tri_table: prebuilt by
    renderer.prepare_render, or built here. Differentiable callers pass
    none of them, so the attribute rows are built inside the graph."""
    check_supported(params)
    if accel is None:
        accel = scene_accel(scene, features)
    if tables is None:
        tables = scene_tables(scene, accel)
    if tri_table is None:
        tri_table = scene_tri_table(scene, accel)
    if features.enable_recursive and features.enable_glossy_reflection:
        shape = trace_glossy
    elif features.enable_recursive and features.enable_transparency:
        shape = trace_tree_trans_recursive
    else:
        shape = trace_chain
    return shape(scene, o, d, features, params, accel, tables, key,
                 tri_table=tri_table, shared_origin=shared_origin,
                 ray_ids=ray_ids)
