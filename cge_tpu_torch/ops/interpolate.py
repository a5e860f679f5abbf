"""Barycentric interpolation (counterpart of cge_tpu/ops/interpolate.py;
reference src/interpolate.cpp). Batched over leading dims."""

from __future__ import annotations

import torch

from cge_tpu_torch.ops import fp32


def barycentric_coord(v0, v1, v2, p):
    """computeBarycentricCoord (interpolate.cpp:4-17), Ericson's method."""
    a, b, c = v1 - v0, v2 - v0, p - v0
    d00, d01, d11 = fp32.dot3(a, a), fp32.dot3(a, b), fp32.dot3(b, b)
    d20, d21 = fp32.dot3(c, a), fp32.dot3(c, b)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1.0 - v - w, v, w], dim=-1)


def interpolate_normal(n0, n1, n2, bary):
    """interpolateNormal (interpolate.cpp:19-23): normalize of the blend / 3
    (the / 3 is kept for parity of intermediates); |n| = 0 maps to 0."""
    n = fp32.div(n0 * bary[..., :1] + n1 * bary[..., 1:2]
                 + n2 * bary[..., 2:3], 3.0)
    n2s = fp32.dot3(n, n)[..., None]
    pos = n2s > 0
    return torch.where(pos, n / fp32.sqrt_rn(torch.where(pos, n2s, 1.0)), 0.0)


def interpolate_texcoord(t0, t1, t2, bary):
    """interpolateTexCoord (interpolate.cpp:25-28)."""
    return t0 * bary[..., :1] + t1 * bary[..., 1:2] + t2 * bary[..., 2:3]
