"""The part of `jax.random` the renderer draws from: threefry2x32-20 keys
and uniform floats, equal to JAX's bit for bit (JAX 0.9 with
`jax_threefry_partitionable`, its default).

A key is a pair (k0, k1) of uint32 words. A frame's keys are Python ints,
so deriving them (`prng_key`, `fold_in` by a number, `split`) runs on the
host and launches nothing. A per-ray key (`fold_in` by a tensor of ray ids)
is a pair of int64 tensors. The arithmetic is int64 with `& 0xFFFFFFFF`
after each add and shift: integer ops are exact on every device, so the
card draws the CPU's bits, and PyTorch's uint32 lacks CUDA kernels for
several of these ops.

JAX's definitions (jax/_src/prng.py, jax/_src/random.py):
  - PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF) of the seed as int32
    in 32-bit mode, so (0, seed mod 2^32);
  - fold_in(key, d) = threefry(key, (0, d));
  - split(key, n)[i] = threefry(key, (0, i)) (the fold-like split);
  - random_bits(key, shape) = y0 ^ y1 of threefry(key, (hi, lo)) at each
    element's flat index (hi, lo its 32-bit words);
  - uniform = max(0, float32(bits >> 9 | 0x3F800000) - 1).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
# torch.profiler labels of the draws (chip_smoke.py reads their kernels)
LABELS = {"uniform": "cge_tpu_torch.threefry",
          "per_ray_uniform": "cge_tpu_torch.threefry_per_ray"}
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(key, x):
    """Threefry-2x32 with 20 rounds (Random123) of the counter pair x under
    key. Each word is a Python int or an int64 tensor in [0, 2^32); tensors
    broadcast. Returns the pair of output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x[0] + ks[0]) & MASK
    x1 = (x[1] + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) for an integer seed (32-bit mode)."""
    return (0, int(seed) & MASK)


def fold_in(key, data):
    """jax.random.fold_in. data: an int (a host key comes back) or an int64
    tensor of ids (one key per element, as a pair of tensors)."""
    if isinstance(data, torch.Tensor):
        return threefry2x32(key, (torch.zeros_like(data), data & MASK))
    return threefry2x32(key, (0, int(data) & MASK))


def split(key, num: int = 2):
    """jax.random.split(key, num): a list of num keys."""
    return [threefry2x32(key, (0, i)) for i in range(num)]


def random_bits(key, shape, device=None):
    """32 random bits for each element of `shape`, as int64 in [0, 2^32),
    on `device` (needed for a host key). A per-element key (tensors of
    shape [N]) draws [N, *shape] on its own device: each row from its own
    key, as jax.vmap of random_bits would."""
    n = math.prod(shape)
    per_row = isinstance(key[0], torch.Tensor)
    if per_row:
        device = key[0].device
    elif device is None:
        raise ValueError("a host key draws on an explicit device")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if per_row:
        key = (key[0][:, None], key[1][:, None])
    y0, y1 = threefry2x32(key, (idx >> 32, idx & MASK))
    bits = y0 ^ y1
    return bits.reshape(*bits.shape[:-1], *shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in [0, 1) from 32 random bits: the top 23 as
    the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).clamp_min(0.0)


def uniform(key, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1)."""
    with torch.profiler.record_function(LABELS["uniform"]):
        return bits_to_uniform(random_bits(key, tuple(shape), device))


def per_ray_uniform(key, ray_ids: torch.Tensor, shape) -> torch.Tensor:
    """[N, *shape] uniforms, row i from fold_in(key, ray_ids[i]): the
    samples a ray draws depend only on the key and its global id, so a
    chunked trace draws what an unchunked one does
    (cge_tpu/render/lights.py:37-42)."""
    with torch.profiler.record_function(LABELS["per_ray_uniform"]):
        keys = fold_in(key, ray_ids.to(torch.int64))
        return bits_to_uniform(random_bits(keys, tuple(shape)))
