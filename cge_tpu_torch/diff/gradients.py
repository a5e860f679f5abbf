"""Differentiable rendering: parameter partition, loss and train step
(counterpart of cge_tpu/diff/gradients.py).

Hit selection is a discrete oracle: the accel, K3's triangle table and both
sweeps run under no_grad, and neither sweep kernel has a backward (the JAX
package has none either). Every continuous quantity (t, barycentrics,
normals, shading, blends) is recomputed from the scene's leaves with plain
autograd, so gradients reach vertices, normals, materials, spheres and
lights in the piecewise-smooth regions; visibility discontinuities are not
differentiated.
"""

from __future__ import annotations

import dataclasses

import torch

from cge_tpu_torch.ops import rng
from cge_tpu_torch.render.wavefront import trace

# SceneArrays leaves that participate in differentiation (the JAX names)
DIFF_FIELDS = (
    "vertices", "normals", "uvs",
    "mat_kd", "mat_ks", "mat_shininess", "mat_transparency",
    "textures",
    "sph_center", "sph_radius",
    "point_pos", "point_color",
    "seg_p0", "seg_p1", "seg_c0", "seg_c1",
    "par_v0", "par_e01", "par_e02",
    "par_c0", "par_c1", "par_c2", "par_c3",
)


def scene_params(scene) -> dict:
    """The differentiable float leaves as a flat dict."""
    return {f: getattr(scene, f) for f in DIFF_FIELDS}


def with_params(scene, params: dict):
    """A SceneArrays with the given differentiable leaves; the integer
    leaves and the host flags (point_mask_host, all_opaque, all_diffuse)
    carry across unchanged."""
    return dataclasses.replace(scene, **params)


def render_loss(params, scene, rays_o, rays_d, target, features,
                render_params, seed: int = 0, ray_ids=None):
    """Mean-squared error of the traced radiance against target, over a ray
    batch. NaN radiance (the reference's pow-quirk pixels) maps to 0, the
    value the image writer emits for it, so the loss stays finite and those
    rays give no gradient. The trace draws from prng_key(seed), so seed s
    gives what the JAX package's render_loss(key=PRNGKey(s)) does."""
    s = with_params(scene, params)
    col = trace(s, rays_o, rays_d, features, render_params,
                rng.prng_key(seed), ray_ids=ray_ids)
    return ((torch.nan_to_num(col) - target) ** 2).mean()


def loss_and_grads(scene, rays_o, rays_d, target, features, render_params,
                   seed: int = 0, ray_ids=None):
    """(loss, {field: gradient}) for every DIFF_FIELDS leaf; a leaf the
    trace does not read gets a zero gradient, as under JAX. ray_ids: the
    rays' global ids (render_loss), as a sharded step passes them."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in scene_params(scene).items()}
    loss = render_loss(params, scene, rays_o, rays_d, target, features,
                       render_params, seed, ray_ids)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(params.items(), grads)}


@torch.no_grad()
def sgd_step(scene, grads: dict, lr: float):
    """Plain SGD on the differentiable leaves. The host flags all_diffuse
    and all_opaque are recomputed from the stepped materials, with one host
    copy of the ks and transparency columns: a stale all_diffuse would
    collapse the TRANS+REC tree after mat_ks moved off zero (the JAX
    package carries both across unchanged)."""
    s = with_params(scene, {k: v - lr * grads[k]
                            for k, v in scene_params(scene).items()})
    mat = torch.cat([s.mat_ks, s.mat_transparency[:, None]], dim=1).cpu()
    return dataclasses.replace(s, all_diffuse=bool((mat[:, :3] == 0).all()),
                               all_opaque=bool((mat[:, 3] == 1).all()))
