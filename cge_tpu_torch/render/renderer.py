"""Image renderer (counterpart of cge_tpu/render/renderer.py:30-267).

renderRayTracing (src/render.cpp:273-329) for the single-sample pinhole
path: one primary ray per pixel at the pixel corner, traced as one
wavefront in chunks of `trace_chunk` rays, then the setPixel y-flip
(screen.cpp:41-47) so row 0 is the top of the image. Pixels are traced in
32x16 screen tiles, so a 512-ray block of the sweep is a compact frustum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cge_tpu_torch.camera import Camera, pixel_grid
from cge_tpu_torch.ops.intersect import Accel
from cge_tpu_torch.render.wavefront import (scene_accel, scene_tables,
                                            scene_tri_table, trace)
from cge_tpu_torch.types import Features, RenderParams, check_supported


@dataclasses.dataclass(frozen=True)
class RenderContext:
    """Scene state reused across frames (the reference builds its BVH once
    per scene, main.cpp:502): with the accel, the packed cluster accel and
    the perm-ordered attribute rows; without it, the brute-force sweep's
    [T, 16] table and the scene-ordered rows."""

    accel: Optional[Accel]
    tables: torch.Tensor                # [L * C, 40] or [T, 40] f32
    tri_table: Optional[torch.Tensor]   # [T, 16] f32 when accel is None


@torch.no_grad()
def prepare_render(scene, features: Features,
                   params: RenderParams) -> RenderContext:
    """Build the per-scene render state once; pass it to render_image.
    Gradients do not flow from a prepared context back to the scene:
    differentiable callers trace without one (diff.gradients)."""
    check_supported(features, params)
    accel = scene_accel(scene, features)
    return RenderContext(accel=accel, tables=scene_tables(scene, accel),
                         tri_table=scene_tri_table(scene, accel))


def _trace_rays(scene, o, d, features, params, shared_origin: bool,
                ctx: RenderContext):
    """Trace [N] rays in chunks of params.trace_chunk, passing each chunk
    its global ray ids. The last chunk is padded with rays at the origin
    along +z, as in the JAX package, so every chunk has one shape."""
    N = o.shape[0]
    C = params.trace_chunk
    kw = dict(accel=ctx.accel, tables=ctx.tables, tri_table=ctx.tri_table,
              shared_origin=shared_origin)
    if N <= C:
        return trace(scene, o, d, features, params, **kw)
    pad = (-N) % C
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype,
                                      device=o.device)])
        dpad = torch.zeros((pad, 3), dtype=d.dtype, device=d.device)
        dpad[:, 2] = 1.0
        d = torch.cat([d, dpad])
    ids = torch.arange(N + pad, dtype=torch.int64, device=o.device)
    cols = [trace(scene, o[s:s + C], d[s:s + C], features, params, **kw,
                  ray_ids=ids[s:s + C])
            for s in range(0, N + pad, C)]
    return torch.cat(cols)[:N]


def _tile_swizzle(width: int, height: int, tw: int = 32, th: int = 16):
    """Pixel permutation into tw x th screen tiles and its inverse (the
    gather path for resolutions the tiles do not divide)."""
    idx = np.arange(width * height).reshape(height, width)
    sw = np.concatenate([idx[by:by + th, bx:bx + tw].ravel()
                         for by in range(0, height, th)
                         for bx in range(0, width, tw)])
    return sw, np.argsort(sw)


def _swizzle_rows(x, width: int, height: int, tw: int = 32, th: int = 16):
    """Scan-order rows [H*W, K] -> 32x16-tile order (by, bx, row, col)."""
    K = x.shape[-1]
    return (x.reshape(height // th, th, width // tw, tw, K)
            .permute(0, 2, 1, 3, 4).reshape(-1, K))


def _unswizzle_rows(x, width: int, height: int, tw: int = 32, th: int = 16):
    """Inverse of _swizzle_rows."""
    K = x.shape[-1]
    return (x.reshape(height // th, width // tw, th, tw, K)
            .permute(0, 2, 1, 3, 4).reshape(height * width, K))


@torch.no_grad()
def render_image(scene, camera: Camera, features: Features,
                 params: RenderParams, width: int, height: int, seed: int = 0,
                 ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """Render [height, width, 3] f32 radiance on the scene's device, row 0
    = top. The headline path is deterministic, so `seed` is unused until
    the stochastic features arrive (ROADMAP 1.2)."""
    del seed
    check_supported(features, params)
    if ctx is None:
        ctx = prepare_render(scene, features, params)
    grid = pixel_grid(width, height, scene.device).reshape(-1, 2)
    tiled = width % 32 == 0 and height % 16 == 0
    if tiled:
        grid = _swizzle_rows(grid, width, height)
    else:
        swizzle, unswizzle = _tile_swizzle(width, height)
        grid = grid[torch.from_numpy(swizzle).to(grid.device)]
    o, d = camera.generate_rays(grid)
    col = _trace_rays(scene, o, d, features, params, shared_origin=True,
                      ctx=ctx)
    if tiled:
        col = _unswizzle_rows(col, width, height)
    else:
        col = col[torch.from_numpy(unswizzle).to(col.device)]
    return torch.flip(col.reshape(height, width, 3), dims=(0,))


def render_image_u8(scene, camera: Camera, features: Features,
                    params: RenderParams, width: int, height: int,
                    seed: int = 0,
                    ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """render_image quantized on the device like Screen::writeBitmapToFile
    (screen.cpp:49-60): NaN -> 0, clamp to [0, 1], x255, truncate to u8."""
    img = render_image(scene, camera, features, params, width, height, seed,
                       ctx)
    img = torch.nan_to_num(img)
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
