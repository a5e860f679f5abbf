"""Phong shading and reflection rays (counterpart of cge_tpu/ops/shading.py;
reference src/shading.cpp), with the reference's quirks:

  - the specular "camera" vector is the incoming normalized ray direction
    (shading.cpp:25), and specular fires only when dot(n, l) > 0 and
    dot(n, ray.dir) > 0 (shading.cpp:29);
  - std::pow with a negative base: sign by parity for integral exponents,
    NaN otherwise (`cpp_pow`), so NaN pixels agree with the C++;
  - computeReflectionRay returns a zero sentinel ray when ks == 0
    (shading.cpp:42-47).
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _normalize(v):
    """Normalize; zero vectors map to zero."""
    n2 = _dot(v, v)[..., None]
    pos = n2 > 0
    return torch.where(pos, v / torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def cpp_pow_masked(base, exp):
    """IEC 60559 pow() as (finite value, NaN mask): negative bases take the
    sign of an integral exponent's parity and are NaN otherwise."""
    ip = torch.round(exp)
    is_int = exp == ip
    odd = torch.remainder(ip, 2.0).abs() == 1.0
    absb = base.abs()
    nonzero = absb > 0
    mag = torch.pow(torch.where(nonzero, absb, 1.0), exp)
    zero_val = torch.where(exp == 0, 1.0,
                           torch.where(exp > 0, 0.0, torch.inf))
    mag = torch.where(nonzero, mag, zero_val)
    neg = base < 0
    val = torch.where(neg & odd & is_int, -mag, mag)
    return val, neg & ~is_int


def cpp_pow(base, exp):
    val, nan_mask = cpp_pow_masked(base, exp)
    return torch.where(nan_mask, torch.nan, val)


def compute_shading(light_pos, light_color, ray_o, ray_d, ray_t,
                    normal, kd, ks, shininess):
    """computeShading (shading.cpp:7-37), batched. ray_d need not be unit:
    the hit point is ray_d * t + ray_o with t in units of |d|."""
    n = _normalize(normal)
    p = ray_d * ray_t[..., None] + ray_o
    light = _normalize(light_pos - p)
    ndl = _dot(n, light)
    diffuse = kd * light_color * ndl.clamp_min(0.0)[..., None]
    camera = _normalize(ray_d)
    gate = (ndl > 0) & (_dot(n, camera) > 0)
    reflection = 2.0 * ndl[..., None] * n - light
    spec_raw, spec_nan = cpp_pow_masked(_dot(camera, reflection), shininess)
    spec = torch.where(gate, spec_raw, 0.0)
    out = diffuse + ks * light_color * spec[..., None]
    return torch.where((gate & spec_nan)[..., None], torch.nan, out)


def compute_reflection_ray(ray_o, ray_d, ray_t, normal, ks):
    """computeReflectionRay (shading.cpp:40-62): (origin, direction, valid);
    the zero sentinel ray where ks == 0."""
    valid = (ks != 0.0).any(dim=-1)
    p = ray_t[..., None] * ray_d + ray_o
    n = _normalize(normal)
    r = _normalize(-ray_d)
    refl = _normalize(2.0 * _dot(n, r)[..., None] * n - r)
    origin = p + 1e-5 * n
    v = valid[..., None]
    return (torch.where(v, origin, 0.0), torch.where(v, refl, 0.0), valid)
