"""Texture sampling (counterpart of cge_tpu/ops/texture.py:20-67; reference
src/texture.cpp:8-48).

  - the v coordinate is flipped: row = (1 - v) * H;
  - nearest: i = min(int(max(u W, 0)), W - 1), j likewise with the flipped
    v, truncating toward zero;
  - bilinear: the floor / ceil texel pair of each axis clamped to [0,
    size - 1], weighted by C fmod(u W, 1), which keeps the sign of a
    negative u (torch.fmod, not the remainder).

Texels are read from the padded [K, TH, TW, 3] stack at a flat index with
index_select, so the backward is an index_add_ into the texels. Each index
is clamped into its axis after the cast: JAX's gather clamps silently,
where index_select raises on the CPU and asserts on the card, and a NaN uv
(a degenerate triangle's barycentrics) casts to INT_MIN on the CPU and to 0
on the card; clamped, both read texel 0 as JAX does.
"""

from __future__ import annotations

import torch

# torch.profiler label of a texel lookup (chip_smoke.py reads its kernels)
LABEL = "cge_tpu_torch.texels"


def _gather(textures, tex_id, j, i):
    """textures [K, TH, TW, 3] at (tex_id, j, i), each [N] int64 within
    its axis -> [N, 3]."""
    _, th, tw, _ = textures.shape
    flat = (tex_id * th + j) * tw + i
    return textures.reshape(-1, 3).index_select(0, flat)


def _index(x, size):
    """Truncate x toward zero to an index in [0, size - 1] (x, size: [N]
    float32): clamped before the cast, so no float overflows the cast, and
    after it, for NaN."""
    top = size - 1.0
    i = torch.minimum(x.clamp_min(0.0), top).to(torch.int64)
    return torch.minimum(i.clamp_min(0), top.to(torch.int64))


def _hw(tex_hw, tex_id):
    hw = tex_hw.index_select(0, tex_id).to(torch.float32)
    return hw[:, 0], hw[:, 1]


def acquire_texel_nearest(textures, tex_hw, tex_id, uv):
    """uv [N, 2] -> [N, 3], tex_id [N] int64 >= 0."""
    h, w = _hw(tex_hw, tex_id)
    i = _index(uv[:, 0] * w, w)
    j = _index((1.0 - uv[:, 1]) * h, h)
    return _gather(textures, tex_id, j, i)


def acquire_texel_bilinear(textures, tex_hw, tex_id, uv):
    """The 2x2 lerp of texture.cpp:19-41; uv [N, 2] -> [N, 3]."""
    h, w = _hw(tex_hw, tex_id)
    fy = (1.0 - uv[:, 1]) * h
    fx = uv[:, 0] * w
    y_up, x_up = _index(torch.ceil(fy), h), _index(torch.ceil(fx), w)
    y_dn, x_dn = _index(torch.floor(fy), h), _index(torch.floor(fx), w)
    x_split = torch.fmod(fx, 1.0)[:, None]
    y_split = torch.fmod(fy, 1.0)[:, None]
    xdyd = _gather(textures, tex_id, y_dn, x_dn)
    xdyu = _gather(textures, tex_id, y_up, x_dn)
    xuyd = _gather(textures, tex_id, y_dn, x_up)
    xuyu = _gather(textures, tex_id, y_up, x_up)
    x1 = (1.0 - x_split) * xdyd + x_split * xuyd
    x2 = (1.0 - x_split) * xdyu + x_split * xuyu
    return (1.0 - y_split) * x1 + y_split * x2


def acquire_texel(textures, tex_hw, tex_id, uv, bilinear: bool):
    """Dispatch on the bilinear flag (texture.cpp:19-47). The caller keeps
    the texel only where tex_id >= 0; other rays read texture 0."""
    with torch.profiler.record_function(LABEL):
        safe_id = tex_id.clamp_min(0)
        if bilinear:
            return acquire_texel_bilinear(textures, tex_hw, safe_id, uv)
        return acquire_texel_nearest(textures, tex_hw, safe_id, uv)
