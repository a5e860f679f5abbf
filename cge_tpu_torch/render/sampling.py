"""Pixel sampling: MSAA jitter grids and depth-of-field rays (counterpart of
cge_tpu/render/sampling.py:22-61; reference src/render.cpp:211-271).

  - getRaySamples: an n x n sub-pixel grid with uniform jitter inside each
    sub-pixel box, one draw of the frame key for the whole frame;
  - getPlane: D = dist - |camera position| (the reference's quirk: the norm
    of the position vector), normal = normalize(lookAt - position);
  - getDOFRays: disk-sampled origins with r = sqrt(U * radius) (uniform in
    radius, then the root: another quirk), the focal point from the centre
    ray and the focal plane, directions left unnormalised.
"""

from __future__ import annotations

import math

import torch

from cge_tpu_torch.ops import fp32, rng
from cge_tpu_torch.ops.shading import _normalize


def msaa_sample_positions(pixel_pos, pixel_size, n: int, key):
    """pixel_pos [N, 2] NDC corners, pixel_size [2] -> [N, n*n, 2] jittered
    positions; sample k = i * n + j sits in sub-box (i, j)."""
    box = fp32.div(pixel_size, float(n))
    ar = torch.arange(n, dtype=torch.float32, device=pixel_pos.device)
    ij = torch.stack(torch.meshgrid(ar, ar, indexing="ij"),
                     dim=-1).reshape(-1, 2)
    base = pixel_pos[:, None, :] + ij[None] * box
    jit = rng.uniform(key, base.shape, pixel_pos.device) * box
    return base + jit


def dof_rays(pixel_pos, camera, focal_length: float, sampling_radius: float,
             n: int, key):
    """pixel_pos [N, 2] -> (origins [N, n, 3], directions [N, n, 3])."""
    dev = pixel_pos.device
    cam_pos = camera.position(dev)
    look = torch.tensor(camera.look_at, dtype=torch.float32, device=dev)
    normal = _normalize(look - cam_pos)
    d_focal = focal_length - fp32.sqrt_rn(fp32.dot3(cam_pos, cam_pos))

    o, d = camera.generate_rays(pixel_pos)
    t = (d_focal - fp32.dot3(o, normal)) / fp32.dot3(d, normal)
    focal_point = o + t[:, None] * d

    zero = normal.new_zeros(())
    axis = (normal[0] == 0) & (normal[1] == 0)
    v1 = torch.where(axis, torch.stack([normal[2], zero, -normal[0]]),
                     torch.stack([-normal[1], normal[0], zero]))
    v1 = _normalize(v1)
    v2 = _normalize(fp32.cross(normal, v1))

    k1, k2 = rng.split(key)
    r = fp32.sqrt_rn(rng.uniform(k1, (pixel_pos.shape[0], n), dev)
                     * sampling_radius)
    theta = rng.uniform(k2, (pixel_pos.shape[0], n), dev) * (2 * math.pi)
    offset = ((r * torch.cos(theta))[..., None] * v1
              + (r * torch.sin(theta))[..., None] * v2)
    origins = o[:, None, :] + offset
    return origins, focal_point[:, None, :] - origins
