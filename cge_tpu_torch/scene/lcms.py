"""LittleCMS 2.17's 8-bit CIE L*a*b* -> sRGB transform, as Pillow 12.1's
`convert("RGB")` of a LAB image builds it (the JAX package's loader reaches
it for TIFF photometric 8 and PSD colour mode 9):
`ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
"LAB", "RGB")`, the perceptual intent and no flags.

The transform, step by step as LittleCMS makes it:

  profiles  the built-in D50 Lab v2 profile (cmsCreateLab2Profile: an
        abstract profile whose AToB0 is an identity CLUT between Lab V4 <->
        V2 matrices) and the built-in sRGB profile (cmsCreate_sRGBProfile:
        v4.3, D65 (0.3127, 0.3290) and the Rec. 709 primaries adapted to D50
        by Bradford in double, the sRGB parametric curve, type 4).
  link  perceptual; black point compensation changes nothing here, as
        both black points are (0, 0, 0) (an abstract profile has none,
        and sRGB's darkest colorant is black); the pipeline is V4->V2, the
        identity CLUT, V2->V4,
        Lab -> XYZ (D50, divided by 1 + 32767/32768), the inverse of the
        colorant matrix times 1 + 32767/32768, and the inverse sRGB curve
        (type -4, analytic).
  optimisation  the identity CLUT and the V2/V4 pair go; what is left is
        resampled (OptimizeByResampling) into a 33x33x33 16-bit CLUT, each
        node through the float pipeline: float32 between stages, each stage
        in double, _cmsQuickSaturateWord at the end. The white-point fix-up
        (FixWhiteMisalignment) patches only a node that Lab's white
        (0xFFFF, 0x8080, 0x8080) lands on, and 0x8080 falls between nodes
        of a 33-point grid, so it patches none.
  pixels  each byte v as v x 257 (Pillow's LAB: L, then a and b offset by
        128), the 16-bit tetrahedral interpolation of the CLUT
        (TetrahedralInterp16, its fixed-point rounding), then 16 -> 8 bits
        as FROM_16_TO_8.

The whole of it is held to Pillow on all 2^24 inputs
(tests/test_torch_lab.py). numpy does the pixels over the whole image; the
curve's pow runs through Python's math.pow (the C library's), as numpy's
vectorised pow may round otherwise.
"""

from __future__ import annotations

import functools
import math

import numpy as np

GRID = 33
# the CLUT's strides (opta) for L, a and b
_STRIDE = (GRID * GRID, GRID, 1)
D50 = (0.9642, 1.0, 0.8249)
# XYZ's encodable maximum, 1 + 32767/32768
MAX_XYZ = 1.0 + 32767.0 / 32768.0
# the sRGB curve's parameters (type 4)
SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_MAGIC = 68719476736.0 * 1.5


def _quick_saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 clamped to [0, 65535], floored as
    _cmsQuickFloor does (to a multiple of 2^-16 first)."""
    d = np.asarray(d, np.float64) + 0.5
    fl = ((d - 32767.0) + _MAGIC) - _MAGIC
    out = np.floor(fl) + 32767.0
    return np.where(d <= 0.0, 0, np.where(d >= 65535.0, 65535, out)) \
        .astype(np.int64)


def _inverse(a):
    """_cmsMAT3inverse."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    """_cmsMAT3per: a x b."""
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(a, v):
    """_cmsMAT3eval."""
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _bradford(src, dst):
    """_cmsAdaptationMatrix with the Bradford cone matrix."""
    cone = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
            [0.0389, -0.0685, 1.0296]]
    s, d = _apply(cone, src), _apply(cone, dst)
    scale = [[d[0] / s[0], 0.0, 0.0], [0.0, d[1] / s[1], 0.0],
             [0.0, 0.0, d[2] / s[2]]]
    return _product(_inverse(cone), _product(scale, cone))


def srgb_colorants():
    """The sRGB profile's RGB -> XYZ (D50) matrix:
    _cmsBuildRGB2XYZtransferMatrix of D65 and the Rec. 709 primaries, then
    _cmsAdaptMatrixToD50."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb],
            [(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)]]
    c = _apply(_inverse(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[c[0] * xr, c[1] * xg, c[2] * xb], [c[0] * yr, c[1] * yg, c[2] * yb],
         [c[0] * (1.0 - xr - yr), c[1] * (1.0 - xg - yg),
          c[2] * (1.0 - xb - yb)]]
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)
    return _product(_bradford(white, D50), m)


def _f_inverse(t: np.ndarray) -> np.ndarray:
    """cmsLab2XYZ's f^-1."""
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def _srgb_inverse_curve(r: np.ndarray) -> np.ndarray:
    """The type -4 parametric curve (DefaultEvalParametricFn) in double."""
    g, a, b, c, d = SRGB
    disc = (a * d + b) ** g
    flat = r.ravel()
    hi = np.array([(math.pow(v, 1.0 / g) - b) / a if v >= disc else 0.0
                   for v in flat.tolist()]).reshape(r.shape)
    return np.where(r >= disc, hi, r / c)


@functools.lru_cache(maxsize=1)
def clut() -> np.ndarray:
    """The resampled 33x33x33 CLUT: int64 [33^3, 3] 16-bit RGB, node (L,
    a, b) at L x 1089 + a x 33 + b."""
    q = _quick_saturate_word(np.arange(GRID, dtype=np.float64) * 65535.0
                             / (GRID - 1))
    l16, a16, b16 = np.meshgrid(q, q, q, indexing="ij")
    f32 = [np.float32(v / 65535.0).astype(np.float64)
           for v in (l16, a16, b16)]
    # Lab -> XYZ (EvaluateLab2XYZ)
    y = (f32[0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (f32[1] * 255.0 - 128.0)
    z = y - 0.005 * (f32[2] * 255.0 - 128.0)
    xyz = [np.float32(_f_inverse(t) * w / MAX_XYZ).astype(np.float64)
           for t, w in ((x, D50[0]), (y, D50[1]), (z, D50[2]))]
    inv = _inverse(srgb_colorants())
    out = []
    for i in range(3):
        tmp = 0.0
        for j in range(3):
            tmp = tmp + xyz[j] * (inv[i][j] * MAX_XYZ)
        lin = np.float32(tmp).astype(np.float64)
        rgb = np.float32(_srgb_inverse_curve(lin)).astype(np.float64)
        out.append(_quick_saturate_word(rgb * 65535.0))
    return np.stack(out, -1).reshape(-1, 3)


@functools.lru_cache(maxsize=1)
def _byte_tables():
    """For each byte v (input v x 257): the grid cell, the fixed-point
    rest and the step to the next node (0 at 0xFFFF), as
    TetrahedralInterp16 computes them."""
    v = np.arange(256, dtype=np.int64) * 257
    fx = v * (GRID - 1)
    fx = fx + (fx + 0x7FFF) // 0xFFFF               # _cmsToFixedDomain
    return fx >> 16, fx & 0xFFFF, (v != 0xFFFF).astype(np.int64)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow LAB bytes [..., 3] (L, a + 128, b + 128) -> sRGB [..., 3]
    uint8, as Pillow's convert("RGB")."""
    shape = lab.shape[:-1]
    px = np.asarray(lab, np.uint8).reshape(-1, 3)
    cell, rest, step = _byte_tables()
    table = clut()
    base = np.zeros(len(px), np.int64)
    r = []
    off = []
    for k in range(3):
        b = px[:, k]
        base += cell[b] * _STRIDE[k]
        r.append(rest[b])
        off.append(step[b] * _STRIDE[k])
    rx, ry, rz = r
    ox, oy, oz = off
    a, b, c, d = rx >= ry, ry >= rz, rz >= rx, rx >= rz
    # the six tetrahedra of TetrahedralInterp16: the rests in falling
    # order and the nodes stepped to on the way (ties give equal sums)
    cases = [a & b, a & ~b & c, a & ~b & ~c, ~a & d, ~a & ~d & b,
             ~a & ~d & ~b]
    first = np.select(cases, [ox, oz, ox, oy, oy, oz])
    second = np.select(cases, [oy, ox, oz, ox, oz, oy])
    third = np.select(cases, [oz, oy, oy, oz, ox, ox])
    r1 = np.select(cases, [rx, rz, rx, ry, ry, rz])
    r2 = np.select(cases, [ry, rx, rz, rx, rz, ry])
    r3 = np.select(cases, [rz, ry, ry, rz, rx, rx])
    v1 = base + first
    v2 = v1 + second
    v3 = v2 + third
    c0, c1, c2, c3 = table[base], table[v1], table[v2], table[v3]
    acc = ((c1 - c0) * r1[:, None] + (c2 - c1) * r2[:, None]
           + (c3 - c2) * r3[:, None] + 0x8001)
    out16 = (c0 + ((acc + (acc >> 16)) >> 16)) & 0xFFFF
    out8 = ((out16 * 65281 + 8388608) >> 24) & 0xFF
    return out8.astype(np.uint8).reshape(*shape, 3)
