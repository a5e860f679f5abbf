"""Screen-space z-buffer rasterizer (counterpart of
cge_tpu/raster/rasterize.py).

The fixed-function raster stage of the reference's preview (GL_FILL front
and back, GL_DEPTH_TEST, GL_SMOOTH; src/main.cpp:560-568): two-sided edge
functions at pixel centres, window-space barycentric depth, the GL_LESS
depth test with the first-drawn triangle winning an exact-z tie, and
Gouraud colours. It runs as torch ops over [pixel_chunk, tri_tile] tiles
of pixels and of the triangles that can reach them. A triangle with a
vertex at w_clip <= 0 is dropped, not clipped (a simplification of the
preview).
"""

from __future__ import annotations

import torch


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _tri_cover_depth(px, py, xy, z, w, tris):
    """Coverage and depth of every triangle at every pixel. px, py: [P]
    pixel centres in window coordinates; xy [V, 2], z [V] ndc depth, w [V]
    clip w; tris [T, 3]. Returns (cover [P, T], depth [P, T])."""
    a, b, c = xy[tris[:, 0]], xy[tris[:, 1]], xy[tris[:, 2]]
    za, zb, zc = z[tris[:, 0]], z[tris[:, 1]], z[tris[:, 2]]
    ok_w = (w[tris[:, 0]] > 0) & (w[tris[:, 1]] > 0) & (w[tris[:, 2]] > 0)
    area2 = _cross2(b[:, 0] - a[:, 0], b[:, 1] - a[:, 1],
                    c[:, 0] - a[:, 0], c[:, 1] - a[:, 1])      # [T]
    pax = px[:, None] - a[None, :, 0]                          # [P, T]
    pay = py[:, None] - a[None, :, 1]
    pbx = px[:, None] - b[None, :, 0]
    pby = py[:, None] - b[None, :, 1]
    # signed sub-triangle areas, oriented as area2
    w_c = _cross2((b[:, 0] - a[:, 0])[None], (b[:, 1] - a[:, 1])[None],
                  pax, pay)
    w_a = _cross2((c[:, 0] - b[:, 0])[None], (c[:, 1] - b[:, 1])[None],
                  pbx, pby)
    w_b = area2[None, :] - w_a - w_c
    s = torch.sign(area2)[None, :]
    nz = area2 != 0
    cover = ((w_a * s >= 0) & (w_b * s >= 0) & (w_c * s >= 0)
             & nz[None, :] & ok_w[None, :])
    inv = torch.where(nz, 1.0 / torch.where(nz, area2, 1.0), 0.0)[None, :]
    depth = ((w_a * inv) * za[None, :] + (w_b * inv) * zb[None, :]
             + (w_c * inv) * zc[None, :])
    cover = cover & (depth >= -1.0) & (depth <= 1.0)    # the clip z range
    return cover, depth


def _pixel_centres(width: int, height: int, device):
    i = torch.arange(width * height, device=device)
    return ((i % width).float() + 0.5, (i // width).float() + 0.5)


@torch.no_grad()
def rasterize(xy, z, w, tris, width: int, height: int,
              pixel_chunk: int = 16384, tri_tile: int = 512):
    """The whole image's visibility on xy's device: (tri_id [H, W] i64,
    -1 for the background; depth [H, W] f32 ndc, 1 where empty). Row 0 is
    the window's bottom (GL); callers flip, as Screen::setPixel does.

    Each pixel gets the covering triangle of least depth, the smallest
    index among equal depths: GL_LESS in draw order, the JAX package's
    rule (the smallest index among a tile's minima; an earlier tile gives
    way only to a strictly closer z). That rule does not depend on how the
    triangles are tiled, so each chunk of pixels tests only the triangles
    whose screen box reaches its rows."""
    dev = xy.device
    tris = tris.to(dev, torch.int64)
    T = tris.shape[0]
    corners = xy[tris]                                       # [T, 3, 2]
    lo, hi = corners.amin(dim=1), corners.amax(dim=1)
    px_all, py_all = _pixel_centres(width, height, dev)
    best_zs, best_is = [], []
    for s in range(0, width * height, pixel_chunk):
        px, py = px_all[s:s + pixel_chunk], py_all[s:s + pixel_chunk]
        best_z = torch.full(px.shape, torch.inf, device=dev)
        best_i = torch.full(px.shape, -1, dtype=torch.int64, device=dev)
        near = ((hi[:, 0] >= px.min() - 1) & (lo[:, 0] <= px.max() + 1)
                & (hi[:, 1] >= py.min() - 1) & (lo[:, 1] <= py.max() + 1))
        cand = near.nonzero()[:, 0]
        for k in range(0, cand.shape[0], tri_tile):
            ids = cand[k:k + tri_tile]
            cover, depth = _tri_cover_depth(px, py, xy, z, w, tris[ids])
            depth = torch.where(cover, depth, torch.inf)
            zmin = depth.amin(dim=1)
            idx = torch.where(depth == zmin[:, None], ids, T + 1).amin(dim=1)
            take = zmin < best_z
            best_z = torch.where(take, zmin, best_z)
            best_i = torch.where(take, idx, best_i)
        best_zs.append(best_z)
        best_is.append(best_i)
    bz = torch.cat(best_zs)
    bz = torch.where(torch.isfinite(bz), bz, 1.0)
    return (torch.cat(best_is).reshape(height, width),
            bz.reshape(height, width))


@torch.no_grad()
def shade_gouraud(tri_id, xy, z, tris, vert_colors, background=None):
    """The deferred Gouraud shade: the window-space barycentric blend of
    the winning triangle's vertex colours (GL_SMOOTH, main.cpp:568), on a
    black background (glClearColor, main.cpp:373) unless given one.
    Returns [H, W, 3] in [0, 1]."""
    H, W = tri_id.shape
    dev = tri_id.device
    flat = tri_id.reshape(-1)
    t = tris.to(dev, torch.int64)[flat.clamp_min(0)]            # [P, 3]
    a, b, c = xy[t[:, 0]], xy[t[:, 1]], xy[t[:, 2]]
    ca, cb, cc = vert_colors[t[:, 0]], vert_colors[t[:, 1]], \
        vert_colors[t[:, 2]]
    px, py = _pixel_centres(W, H, dev)
    area2 = _cross2(b[:, 0] - a[:, 0], b[:, 1] - a[:, 1],
                    c[:, 0] - a[:, 0], c[:, 1] - a[:, 1])
    w_c = _cross2(b[:, 0] - a[:, 0], b[:, 1] - a[:, 1],
                  px - a[:, 0], py - a[:, 1])
    w_a = _cross2(c[:, 0] - b[:, 0], c[:, 1] - b[:, 1],
                  px - b[:, 0], py - b[:, 1])
    w_b = area2 - w_a - w_c
    nz = area2 != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, area2, 1.0), 0.0)
    col = ((w_a * inv)[:, None] * ca + (w_b * inv)[:, None] * cb
           + (w_c * inv)[:, None] * cc)
    bg = (torch.zeros(3, device=dev) if background is None else
          torch.as_tensor(background, dtype=torch.float32, device=dev))
    col = torch.where((flat >= 0)[:, None], col, bg)
    return col.reshape(H, W, 3).clamp(0.0, 1.0)
