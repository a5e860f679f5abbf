"""Bloom post-filter (counterpart of cge_tpu/render/bloom.py:22-52;
reference renderBloomFilter and weightsGaussian, src/render.cpp:158-210).

  - luma 0.2126 / 0.7152 / 0.0722; pixels strictly below the threshold are
    zeroed in the bright-pass copy;
  - a 3x3 Gaussian of sigma 1 built with the literal 3.1415, normalised by
    its own sum, summed as nine shifted adds over a zero-padded copy in
    the JAX package's order (dy outer, dx inner): a convolution would pick
    its own summation order, and on the card may take TF32;
  - the write loop skips the last screen row and column, so in buffer
    coordinates (row 0 the top) buffer row 0 and the last column keep the
    image;
  - debug option 0 = image + bloom, 1 = bloom only, 2 = the image.
"""

from __future__ import annotations

import numpy as np
import torch

# torch.profiler label of the pass (chip_smoke.py reads its kernels)
LABEL = "cge_tpu_torch.bloom"


def weights_gaussian(sigma: float = 1.0) -> np.ndarray:
    """The 3x3 kernel as float32, normalised by its own sum."""
    w = np.empty((3, 3), np.float32)
    for i in range(-1, 2):
        for k in range(-1, 2):
            w[i + 1, k + 1] = np.exp(-(i * i + k * k) / (2 * sigma * sigma)) / (
                2 * 3.1415 * sigma * sigma)
    return (w / w.sum()).astype(np.float32)


def render_bloom_filter(buffer: torch.Tensor, params) -> torch.Tensor:
    """buffer [H, W, 3], row 0 = top -> the filtered buffer."""
    with torch.profiler.record_function(LABEL):
        H, W = buffer.shape[:2]
        luma = (0.2126 * buffer[..., 0] + 0.7152 * buffer[..., 1]
                + 0.0722 * buffer[..., 2])
        bright = torch.where((luma < params.bloom_threshold)[..., None], 0.0,
                             buffer)
        w = weights_gaussian(1.0)
        padded = torch.nn.functional.pad(bright, (0, 0, 1, 1, 1, 1))
        blur = torch.zeros_like(buffer)
        for dy in range(3):
            for dx in range(3):
                blur = blur + float(w[dy, dx]) * padded[dy:dy + H, dx:dx + W]
        if params.bloom_debug_option == 1:
            new = blur * params.bloom_scalar
        elif params.bloom_debug_option == 2:
            new = buffer
        else:
            new = buffer + blur * params.bloom_scalar
        out = buffer.clone()
        out[1:, :W - 1] = new[1:, :W - 1]
        return out
