"""Float32 arithmetic that rounds alike on every device.

The card and the CPU twins build the same tables and rays only where each
op rounds its exact result once, to nearest, as IEEE addition,
multiplication and division do on both, in the same order. Five PyTorch
forms do not: a fused torch.linalg.cross may contract a multiply into its
subtract (the CPU build does), a .sum over a 3-vector adds in another
order on the card than on the CPU, a CUDA division by a Python number
multiplies by its reciprocal, and the float32 square root and power are
not rounded to nearest on every build (PERF.md has the measurements).
So the port spells its cross and dot products as separate multiplies and
adds in a fixed order, and takes those divisions, square roots and powers
here. tests/test_torch_op_diff.py holds the forms to the same bits on the
CPU and the card; chip_smoke.py phase 7 holds the small train step's
tables, hits, loss and gradients on both devices to each other.
"""

from __future__ import annotations

import torch


def cross(a, b):
    """a x b over the last axis, one rounding per multiply and subtract:
    (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)."""
    return (torch.roll(a, -1, dims=-1) * torch.roll(b, 1, dims=-1)
            - torch.roll(a, 1, dims=-1) * torch.roll(b, -1, dims=-1))


def dot3(a, b):
    """a . b over the last axis of 3, summed (x + y) + z on every device:
    the order of the CPU build's .sum and of the JAX package's sums, which
    the CPU tests hold the port to. CUDA's .sum over a 3-vector adds
    (x + z) + y (measured on an H100, PERF.md), so the order is spelt
    out: one multiply and two adds, a kernel more than a .sum. The
    products are unbound, not indexed, so the backward stacks their
    gradients in one op."""
    x, y, z = (a * b).unbind(dim=-1)
    return (x + y) + z


def div(x, c: float):
    """x / c for a Python number c, rounded once on every device: c as a
    0-dim tensor on x's device (a CPU scalar divisor makes CUDA multiply by
    its reciprocal, which rounds twice)."""
    return x / x.new_full((), c)


def pow_f64(base, exp):
    """base ** exp for float32 tensors, taken in float64 and rounded to
    float32. Neither device's float64 power is exact, but both round to
    the same float32 unless their results straddle a float32 midpoint
    (about 2^-28 of values), where the float32 powers of the two devices
    part on a few percent of values."""
    return torch.pow(base.double(), exp.double()).to(base.dtype)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root of a float32 tensor rounded to nearest on every
    device. CUDA's float32 square root is IEEE's (sqrt.rn), so a CUDA
    tensor takes torch.sqrt. Elsewhere the root is taken in float64, where
    IEEE's square root is correctly rounded, and rounded to float32: a
    correctly rounded root of 53 bits >= 2 x 24 + 2 rounds to the nearest
    float32 root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)
