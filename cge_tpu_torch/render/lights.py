"""Shadow visibility, light sampling and per-hit radiance (counterpart of
cge_tpu/render/lights.py; reference src/light.cpp).

testVisibilityLightSample (light.cpp:49-73): the hit point is pulled back
1e-5 along the normalized ray and a budget-1 shadow segment runs to the
light sample. With transparency off only the existence of a blocker
matters (light.cpp:60-63), so the any-hit sweep answers it; without the
accel that query is the forward closest hit of the brute-force sweep (K3).
With transparency on the visibility is the closest blocker's material
transparency (light.cpp:65-68), so the query is a forward closest hit on
either sweep, with the closest-hit knobs and no reversal or ray sort
(cge_tpu/render/lights.py:95-106). Under a prims axis (RenderParams.
prims_axis) every shadow query is that forward closest hit through the
prims-sharded sweep, as in the JAX package (lights.py:71-72): the any-hit
walk and its reversal do not run.

Segment and parallelogram lights (soft shadows) draw their jitter from
threefry streams keyed per ray by global ray id (ops/rng.py), as the JAX
package does, so the same seed gives the same samples on both packages and
on every device.
"""

from __future__ import annotations

import torch

from cge_tpu_torch.ops import fp32, rng
from cge_tpu_torch.ops.intersect import any_hit_occlusion, closest_hit
from cge_tpu_torch.ops.shading import compute_shading


def shadow_visibility(scene, ray_o, ray_d, ray_t, sample_pos, features,
                      params, alive=None, accel=None, tri_table=None):
    """Visibility [N] of `sample_pos` from each hit point: in {0, 1}, or
    with transparency the closest blocker's transparency. alive: optional
    [N] bool; dead rays get a -1 budget and cost the sweep nothing. accel /
    tri_table: what the triangle sweep runs over (see
    ops.intersect.closest_hit)."""
    N = ray_o.shape[0]
    if not (features.enable_hard_shadow or features.enable_soft_shadow):
        return torch.ones(N, dtype=torch.float32, device=ray_o.device)
    d2 = fp32.dot3(ray_d, ray_d)[..., None]
    dpos = d2 > 0
    dlen = torch.where(dpos, fp32.sqrt_rn(torch.where(dpos, d2, 1.0)), 0.0)
    dhat = torch.where(dpos, ray_d / torch.where(dpos, dlen, 1.0), 0.0)
    p = ray_o + dhat * (ray_t * dlen[..., 0] - 1e-5)[..., None]
    sdir = sample_pos - p
    if alive is None:
        tmax = torch.ones(N, dtype=torch.float32, device=p.device)
    else:
        tmax = torch.where(alive, 1.0, -1.0)
    if features.enable_transparency:
        return blocker_transparency(scene, p, sdir, tmax, params, accel,
                                    tri_table)
    if params.prims_axis is not None:
        hit = closest_hit(scene, p, sdir, tmax, accel, tri_table=tri_table,
                          br=params.sweep_br, sc_n=params.sweep_sc_n,
                          exact_keys=params.sweep_exact_keys,
                          prims_axis=params.prims_axis).hit
        return torch.where(hit, 0.0, 1.0)
    # the cluster sweep runs reversed, from the light sample toward the
    # hit point: the same [p, sample] segment and budget-1 acceptance set,
    # with a tight origin hull per block; spheres test forward
    rev = ((sample_pos, p - sample_pos)
           if params.sweep_shadow_reverse and accel is not None else None)
    blocked = any_hit_occlusion(scene, p, sdir, tmax, accel,
                                tri_table=tri_table, br=params.sweep_br,
                                tri_rays=rev,
                                sc_n=params.sweep_anyhit_sc_n,
                                exact_keys=params.sweep_anyhit_exact_keys,
                                sort_rays=bool(params.sweep_sort_shadow))
    return torch.where(blocked, 0.0, 1.0)


def blocker_transparency(scene, p, sdir, tmax, params, accel=None,
                         tri_table=None):
    """The closest blocker's material transparency on each segment, 1
    where none blocks it. The hit ids are scene triangle ids (closest_hit
    maps the accel's slots back); every index is clamped into its own
    table (a miss reports 0, a sphere index is no triangle id). The
    gathers sit outside the sweep's no_grad, so mat_transparency gets its
    gradient."""
    ids = closest_hit(scene, p, sdir, tmax, accel, tri_table=tri_table,
                      br=params.sweep_br, sc_n=params.sweep_sc_n,
                      exact_keys=params.sweep_exact_keys,
                      prims_axis=params.prims_axis)
    tri = ids.prim.clamp(0, scene.tri_mat.shape[0] - 1)
    sph = ids.prim.clamp(0, scene.sph_mat.shape[0] - 1)
    tr = scene.mat_transparency
    blocker = torch.where(ids.is_sphere,
                          tr.index_select(0, scene.sph_mat[sph]),
                          tr.index_select(0, scene.tri_mat[tri]))
    return torch.where(ids.hit, blocker, 1.0)


def sample_segment_light(p0, p1, c0, c1, index, n_samples: int, r):
    """sampleSegmentLight (light.cpp:19-26): w = (index + r) / samples."""
    w = fp32.div(index + r, float(n_samples))[..., None]
    return (p1 - p0) * w + p0, w * c1 + (1.0 - w) * c0


def sample_parallelogram_light(v0, e01, e02, c0, c1, c2, c3, hi, vi,
                               na: int, nb: int, r1, r2):
    """sampleParallelogramLight (light.cpp:30-45): stratified jitter,
    bilinear colour."""
    hw = fp32.div(hi + r1, float(na))[..., None]
    vw = fp32.div(vi + r2, float(nb))[..., None]
    pos = v0 + hw * e01 + vw * e02
    bottom = hw * c1 + (1.0 - hw) * c0
    top = hw * c3 + (1.0 - hw) * c2
    return pos, vw * top + (1.0 - vw) * bottom


def _repeat(x, m: int):
    """jnp.repeat(x, m, axis=0): each row m times in a row."""
    return x[:, None].expand(x.shape[0], m, *x.shape[1:]).reshape(
        x.shape[0] * m, *x.shape[1:])


def _sampled_light(scene, ray_o, ray_d, ray_t, normal, kd, ks, shininess,
                   features, params, alive, accel, tri_table, pos, col):
    """The mean over a light's M samples a ray (pos, col: [N, M, 3]) of
    the shaded, shadowed sample: the samples flattened into the ray axis
    for one batched shadow sweep (lights.py:189-204)."""
    n, m = pos.shape[:2]
    rep = [_repeat(x, m) for x in (ray_o, ray_d, ray_t, normal, kd, ks,
                                   shininess)]
    pos_f, col_f = pos.reshape(-1, 3), col.reshape(-1, 3)
    sh = compute_shading(pos_f, col_f, *rep)
    vis = shadow_visibility(scene, *rep[:3], pos_f, features, params,
                            None if alive is None else _repeat(alive, m),
                            accel, tri_table)
    return fp32.div((sh * vis[..., None]).reshape(n, m, 3).sum(dim=1),
                    float(m))


def draws_samples(scene, features) -> bool:
    """Whether light_contribution reads its key: soft shadows over a live
    segment or parallelogram light."""
    return bool(features.enable_shading and features.enable_soft_shadow
                and (any(scene.seg_mask_host) or any(scene.par_mask_host)))


class DrawKeys(tuple):
    """The keys light_contribution draws from, in the order it draws
    (draw_keys), passed in place of the level's key."""


def draw_keys(scene, key) -> DrawKeys:
    """The keys of a level's light samples, derived on the host from its
    key: fold_in(key, 1000 + li) for each live segment light, then
    fold_in(k, 0) and fold_in(k, 1) of k = fold_in(key, 2000 + li) for each
    live parallelogram light. A CUDA graph's replay passes them as device
    tensors (render.graphs), so one graph draws under every key."""
    keys = [rng.fold_in(key, 1000 + li)
            for li, on in enumerate(scene.seg_mask_host) if on]
    for li, on in enumerate(scene.par_mask_host):
        if on:
            k = rng.fold_in(key, 2000 + li)
            keys += [rng.fold_in(k, 0), rng.fold_in(k, 1)]
    return DrawKeys(keys)


def light_contribution(scene, ray_o, ray_d, ray_t, normal, kd, ks, shininess,
                       features, params, key, alive=None, accel=None,
                       tri_table=None, ray_ids=None):
    """computeLightContribution (light.cpp:108-165), batched over rays:
    [N, 3]. Point lights, then (with soft shadows) segment lights of
    `segment_light_samples` jittered samples and parallelogram lights of
    `parallelogram_light_direction_samples`^2. key: the level's key
    (ops.rng), or the keys draw_keys derives from it; ray_ids (global ray
    ids, arange(N) when None) key each
    ray's samples, so chunking does not change them. Dead light slots are
    skipped from the host copies of the masks: no device sync."""
    if not features.enable_shading:
        return kd                                  # light.cpp:161-164
    N = ray_o.shape[0]
    dev = ray_o.device
    result = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    for li, on in enumerate(scene.point_mask_host):
        if not on:
            continue
        pos = scene.point_pos[li].expand(N, 3)
        col = scene.point_color[li].expand(N, 3)
        sh = compute_shading(pos, col, ray_o, ray_d, ray_t, normal, kd, ks,
                             shininess)
        if features.enable_hard_shadow:
            sh = sh * shadow_visibility(scene, ray_o, ray_d, ray_t, pos,
                                        features, params, alive, accel,
                                        tri_table)[..., None]
        result = result + sh
    if not features.enable_soft_shadow:
        return result
    if ray_ids is None:
        ray_ids = torch.arange(N, dtype=torch.int64, device=dev)
    keys = iter(key if isinstance(key, DrawKeys) else draw_keys(scene, key))
    shade = (scene, ray_o, ray_d, ray_t, normal, kd, ks, shininess,
             features, params, alive, accel, tri_table)

    ss = params.segment_light_samples
    idx = torch.arange(ss, dtype=torch.float32, device=dev)
    for li, on in enumerate(scene.seg_mask_host):
        if not on:
            continue
        r = rng.per_ray_uniform(next(keys), ray_ids, (ss,))
        pos, col = sample_segment_light(
            scene.seg_p0[li], scene.seg_p1[li], scene.seg_c0[li],
            scene.seg_c1[li], idx, ss, r)
        result = result + _sampled_light(*shade, pos, col)

    ps = params.parallelogram_light_direction_samples
    grid = torch.arange(ps, dtype=torch.float32, device=dev)
    hi = grid[:, None].expand(ps, ps).reshape(-1)      # sample a * ps + b:
    vi = grid[None, :].expand(ps, ps).reshape(-1)      # hi = a, vi = b
    for li, on in enumerate(scene.par_mask_host):
        if not on:
            continue
        r1 = rng.per_ray_uniform(next(keys), ray_ids, (ps * ps,))
        r2 = rng.per_ray_uniform(next(keys), ray_ids, (ps * ps,))
        pos, col = sample_parallelogram_light(
            scene.par_v0[li], scene.par_e01[li], scene.par_e02[li],
            scene.par_c0[li], scene.par_c1[li], scene.par_c2[li],
            scene.par_c3[li], hi, vi, ps, ps, r1, r2)
        result = result + _sampled_light(*shade, pos, col)
    return result
