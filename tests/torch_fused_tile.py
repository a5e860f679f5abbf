"""The cluster walk's dense tile with the JAX kernel's multiply-adds fused,
for tests only.

XLA's CPU compiler runs the JAX package's interpreted Pallas cluster
kernel (cge_tpu/ops/pallas/cluster_sweep.py:409-432) with each a * b + c
of the plane t and the edge sums contracted into one fused multiply-add.
The port rounds every product and sum apart, as the compiled reference
renderer does (cge_tpu_torch/ops/cluster_sweep.py `_tile_vpu`), so on a
ray whose origin lies on a triangle's plane o.n - D can be 0 in the port
and -6e-8 in JAX. `tile_vpu_fused` is `_tile_vpu` with the same
multiply-adds fused; a test patches it over `cluster_sweep._tile_vpu` to
show that this op alone parts the two.
"""

import torch


def fma(a, b, c):
    """a * b + c for float32 tensors rounded once, to nearest. The product
    is exact in float64; the float64 sum is rounded to odd (an inexact sum
    takes its neighbour with an odd last bit), which, with 53 >= 2 x 24 + 2
    bits, rounds to the float32 nearest the exact sum (Boldo and
    Melquiond, 2008)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    back = s - p                                 # TwoSum: p + c = s + err
    err = (p - (s - back)) + (c64 - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def tile_vpu_fused(T, r, shared_origin):
    """cluster_sweep._tile_vpu's t and edge tests [A, C, BR] with each
    multiply-add fused where XLA contracts the JAX kernel's: d.n =
    fma(dz, nz, fma(dx, nx, dy ny)), o.n likewise, p = fma(t, d, o),
    m_k.p - b_k = fma(pz, mz, fma(py, my, fma(px, mx, -b_k))), whose last
    multiply-add only gives a sign, which its float64 sum keeps.

    Only lanes live (tmax >= 0) in some block are computed, to keep the
    tests quick; a lane dead in every block gets t NaN and no inside,
    which no walk takes."""
    o0 = [r[:, k, None, :1] for k in range(3)] if shared_origin else None
    live = (r[:, 6] >= 0).any(dim=0)                             # [BR]
    if bool(live.all()):
        return _fused(T, r, o0)
    keep = torch.nonzero(live)[:, 0]
    t_k, in_k = _fused(T, r[:, :, keep], o0)
    A, C, BR = T.shape[0], T.shape[1], r.shape[2]
    t = torch.full((A, C, BR), float("nan"), dtype=t_k.dtype)
    inside = torch.zeros((A, C, BR), dtype=torch.bool)
    t[:, :, keep], inside[:, :, keep] = t_k, in_k
    return t, inside


def _fused(T, r, o0):
    def col(k):
        return T[:, :, k, None]                                 # [A, C, 1]

    o = [r[:, k, None] for k in range(3)]                       # [A, 1, BR]
    d = [r[:, 3 + k, None] for k in range(3)]
    o3 = o if o0 is None else o0
    nx, ny, nz, D = col(0), col(1), col(2), col(3)
    dn = fma(d[2], nz, fma(d[0], nx, d[1] * ny))
    on = fma(o3[2], nz, fma(o3[0], nx, o3[1] * ny))
    t = (D - on) / dn
    px, py, pz = (fma(t, d[k], o[k]) for k in range(3))
    inside = None
    for k in range(3):
        mx, my, mz, b = (col(4 * k + 4 + j) for j in range(4))
        part = fma(py, my, fma(px, mx, -b))
        e = pz.double() * mz.double() + part.double()
        inside = (e >= 0) if inside is None else inside & (e >= 0)
    return t, inside
