"""Brute-force closest-hit sweep (counterpart of cge_tpu/ops/pallas/sweep.py).

The hit oracle when the accel is off: every ray against every triangle of
the scene, in scene order. The triangles are packed once into a [T, 16]
table (`pack_tri_table`); `closest_tris` returns each ray's closest
accepted t and its triangle id, with the Pallas kernel's acceptance and tie
rules:

  - accept iff 0 <= t <= tmax, the three edge tests pass and the row is
    valid; rays with tmax < 0 are dead;
  - the closest finite t wins, and on equal t the largest triangle id.

K3 is a CUDA kernel (csrc/sweep.cu): 2 rays a thread, the edge vectors
hoisted per triangle, the triangle range split over the grid
(split_count) and merged in id order. Beside it stands its plain PyTorch
twin (`closest_tris_plain`), which computes in the Pallas kernel's operation
order, so on the card the two agree bit for bit. A CPU tensor runs the twin;
a CUDA tensor launches the kernel or raises: there is no fallback between
the two. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from cge_tpu_torch import _kernels
from cge_tpu_torch.ops import fp32

TILE = 128            # triangle rows per tile: csrc/sweep.cu's SWEEP_TILE
# The triangle range is split every TILES_PER_SPLIT tiles (256 rows), up to
# MAX_SPLIT splits: a block whose few live rays sweep all T rows on a few
# threads would take as long as a full one (bounce levels of a 65k-ray
# chunk keep ~100 live rays), and the splits fill the card at small ray
# counts. At the main path's 16k-ray batches a split every tile ran 1-7%
# faster than every 2 tiles and every 4 tiles 8-20% slower
# (tools/kernel_bench.py --shapes); every 2 keeps the partials at half the
# memory of every tile.
TILES_PER_SPLIT = 2
MAX_SPLIT = 64

LAUNCHES = {"sweep": 0}


@torch.no_grad()
def pack_tri_table(vertices, tris, mask):
    """The packed [T, 16] f32 table: v0, v1, v2, the plane normal n and D
    (trianglePlane semantics), the valid flag, 2 pad columns. n is
    normalized with the plain norm, as in the JAX package, so a zero-area
    row gets NaN constants and is never hit. Hit selection is discrete:
    the table is built from detached vertices."""
    v = vertices.detach()
    v0, v1, v2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    n = fp32.cross(v1 - v0, v2 - v0)
    n = n / fp32.sqrt_rn(fp32.dot3(n, n))[:, None]
    D = fp32.dot3(n, v0)
    zero = torch.zeros_like(D)
    return torch.cat([v0, v1, v2, n, D[:, None], mask.float()[:, None],
                      zero[:, None], zero[:, None]], dim=1).float().contiguous()


def closest_tris_plain(o, d, tmax, table, ray_tile: int = 2048,
                       tri_tile: int = TILE):
    """Plain twin of K3. o, d: [R, 3]; tmax: [R]; table: [T, 16]. Returns
    (best_t [R] f32, +inf on miss; best_i [R] i32, -1 on miss). The sweep
    runs in ray_tile x tri_tile pieces, which bound the intermediates; a
    later triangle tile replaces on t <= best, so the pieces do not change
    the result."""
    R, T = o.shape[0], table.shape[0]
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=o.device)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    for r0 in range(0, R, ray_tile):
        r1 = min(R, r0 + ray_tile)
        ox, oy, oz = (o[r0:r1, k, None] for k in range(3))          # [r, 1]
        dx, dy, dz = (d[r0:r1, k, None] for k in range(3))
        tm = tmax[r0:r1, None]
        bt, bi = best_t[r0:r1], best_i[r0:r1]
        for s in range(0, T, tri_tile):
            tri = table[s:s + tri_tile]

            def col(k):
                return tri[None, :, k]                               # [1, tt]

            v = [(col(3 * j), col(3 * j + 1), col(3 * j + 2))
                 for j in range(3)]
            nx, ny, nz, D, valid = col(9), col(10), col(11), col(12), col(13)
            denom = (dx * nx + dy * ny) + dz * nz
            t = (D - ((ox * nx + oy * ny) + oz * nz)) / denom
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
            inside = None
            for j in range(3):
                (ax, ay, az), (bx, by, bz) = v[j], v[(j + 1) % 3]
                ex, ey, ez = bx - ax, by - ay, bz - az
                wx, wy, wz = px - ax, py - ay, pz - az
                cx = ey * wz - ez * wy
                cy = ez * wx - ex * wz
                cz = ex * wy - ey * wx
                e = (cx * nx + cy * ny) + cz * nz >= 0
                inside = e if inside is None else inside & e
            ok = (t >= 0) & (t <= tm) & inside & (valid > 0)
            t = torch.where(ok, t, torch.inf)
            tmin = t.amin(dim=1)
            ids = torch.arange(s, s + tri.shape[0], dtype=torch.int32,
                               device=o.device)
            idx = torch.where(t == tmin[:, None], ids, -1).amax(dim=1)
            take = (tmin <= bt) & torch.isfinite(tmin)
            bt = torch.where(take, tmin, bt)
            bi = torch.where(take, idx, bi)
        best_t[r0:r1], best_i[r0:r1] = bt, bi
    return best_t, best_i


def _check(t, name, shape, dtype, device):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape "
                         f"{shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def split_count(T: int) -> int:
    """Splits of the triangle range: one per TILES_PER_SPLIT tiles, at
    least 1 and at most MAX_SPLIT."""
    return max(1, min(MAX_SPLIT, -(-T // (TILE * TILES_PER_SPLIT))))


@torch.no_grad()
def closest_tris(o, d, tmax, table):
    """K3: closest triangle hit of every ray. o, d: [R, 3] f32; tmax: [R]
    f32 (-1 = dead); table: [T, 16] from pack_tri_table. Returns (best_t
    [R] f32, +inf on miss; best_i [R] i32 scene-order id, -1 on miss). CPU
    tensors run the plain twin; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return closest_tris_plain(o, d, tmax, table)
    if o.device.type != "cuda":
        raise ValueError(f"closest_tris: unsupported device {o.device}")
    R, T = o.shape[0], table.shape[0]
    dev = o.device
    _check(o, "o", (R, 3), torch.float32, dev)
    _check(d, "d", (R, 3), torch.float32, dev)
    _check(tmax, "tmax", (R,), torch.float32, dev)
    _check(table, "table", (T, 16), torch.float32, dev)
    if table.data_ptr() % 16:
        raise ValueError("closest_tris: the table must be 16-byte aligned")
    best_t = torch.empty(R, dtype=torch.float32, device=dev)
    best_i = torch.empty(R, dtype=torch.int32, device=dev)
    n_split = split_count(T)
    if n_split > 1:
        part_t = torch.empty((n_split, R), dtype=torch.float32, device=dev)
        part_i = torch.empty((n_split, R), dtype=torch.int32, device=dev)
    else:
        part_t, part_i = best_t, best_i
    lib = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib.check(lib.cge_closest_tris_sweep(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), table.data_ptr(),
        best_t.data_ptr(), best_i.data_ptr(), part_t.data_ptr(),
        part_i.data_ptr(), R, T, n_split, stream), "cge_closest_tris_sweep")
    LAUNCHES["sweep"] += 1
    return best_t, best_i
