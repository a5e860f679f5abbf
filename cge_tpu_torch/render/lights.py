"""Shadow visibility and per-hit radiance from point lights
(counterpart of cge_tpu/render/lights.py:45-107, 130-175; reference
src/light.cpp).

testVisibilityLightSample (light.cpp:49-73): the hit point is pulled back
1e-5 along the normalized ray and a budget-1 shadow segment runs to the
light sample; with transparency off only the existence of a blocker
matters (light.cpp:60-63), so the any-hit sweep answers it. Without the
accel the query is the forward closest hit of the brute-force sweep (K3).
"""

from __future__ import annotations

import torch

from cge_tpu_torch.ops.intersect import any_hit_occlusion
from cge_tpu_torch.ops.shading import compute_shading


def shadow_visibility(scene, ray_o, ray_d, ray_t, sample_pos, features,
                      params, alive=None, accel=None, tri_table=None):
    """Visibility [N] in {0, 1} of `sample_pos` from each hit point. alive:
    optional [N] bool; dead rays get a -1 budget and cost the sweep
    nothing. accel / tri_table: what the triangle sweep runs over (see
    ops.intersect.closest_hit)."""
    N = ray_o.shape[0]
    if not (features.enable_hard_shadow or features.enable_soft_shadow):
        return torch.ones(N, dtype=torch.float32, device=ray_o.device)
    if features.enable_transparency:
        raise NotImplementedError(
            "transparency shadows (closest blocker's transparency, "
            "light.cpp:65-68): see ROADMAP 1.5")
    d2 = (ray_d * ray_d).sum(dim=-1, keepdim=True)
    dpos = d2 > 0
    dlen = torch.where(dpos, torch.sqrt(torch.where(dpos, d2, 1.0)), 0.0)
    dhat = torch.where(dpos, ray_d / torch.where(dpos, dlen, 1.0), 0.0)
    p = ray_o + dhat * (ray_t * dlen[..., 0] - 1e-5)[..., None]
    sdir = sample_pos - p
    if alive is None:
        tmax = torch.ones(N, dtype=torch.float32, device=p.device)
    else:
        tmax = torch.where(alive, 1.0, -1.0)
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


def light_contribution(scene, ray_o, ray_d, ray_t, normal, kd, ks, shininess,
                       features, params, alive=None, accel=None,
                       tri_table=None, ray_ids=None):
    """computeLightContribution (light.cpp:108-165) for point lights,
    batched over rays: [N, 3]. ray_ids (global ray ids) key the stochastic
    light samples, which arrive with soft shadows (ROADMAP 1.2)."""
    del ray_ids
    if not features.enable_shading:
        return kd                                  # light.cpp:161-164
    if features.enable_soft_shadow:
        raise NotImplementedError(
            "soft shadows (segment/parallelogram lights): see ROADMAP 1.2")
    N = ray_o.shape[0]
    result = torch.zeros((N, 3), dtype=torch.float32, device=ray_o.device)
    # dead slots are skipped from the host copy of the mask: no device sync
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
    return result
