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
    rays give no gradient. seed stands where the JAX package takes its
    PRNG key; the deterministic features use no randomness, so it is not
    read until the stochastic features are ported (ROADMAP 1.2)."""
    del seed
    s = with_params(scene, params)
    col = trace(s, rays_o, rays_d, features, render_params, ray_ids=ray_ids)
    return ((torch.nan_to_num(col) - target) ** 2).mean()


def loss_and_grads(scene, rays_o, rays_d, target, features, render_params,
                   seed: int = 0):
    """(loss, {field: gradient}) for every DIFF_FIELDS leaf; a leaf the
    trace does not read gets a zero gradient, as under JAX."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in scene_params(scene).items()}
    loss = render_loss(params, scene, rays_o, rays_d, target, features,
                       render_params, seed)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(params.items(), grads)}


@torch.no_grad()
def sgd_step(scene, grads: dict, lr: float):
    """Plain SGD on the differentiable leaves."""
    return with_params(scene, {k: v - lr * grads[k]
                               for k, v in scene_params(scene).items()})
