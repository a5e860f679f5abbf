"""Image renderer (counterpart of cge_tpu/render/renderer.py:30-274).

renderRayTracing (src/render.cpp:273-329): one primary ray per pixel at the
pixel corner, or an MSAA grid and / or depth-of-field samples with the
reference's weighting (DoF counts 3x, render.cpp:305-314), traced as one
wavefront in chunks of `trace_chunk` rays; then the setPixel y-flip
(screen.cpp:41-47) so row 0 is the top of the image, then the optional
bloom pass; a batch of cameras renders one after another. Pixels are
traced in 32x16 screen tiles, so a 512-ray block of the sweep is a compact
frustum. Every draw comes from the frame key prng_key(seed) (ops/rng.py),
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cge_tpu_torch.camera import Camera, pixel_grid
from cge_tpu_torch.ops import fp32, rng
from cge_tpu_torch.ops.intersect import Accel
from cge_tpu_torch.render.bloom import render_bloom_filter
from cge_tpu_torch.render.sampling import dof_rays, msaa_sample_positions
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
    check_supported(params)
    accel = scene_accel(scene, features)
    return RenderContext(accel=accel, tables=scene_tables(scene, accel),
                         tri_table=scene_tri_table(scene, accel))


def _trace_rays(scene, o, d, features, params, key, shared_origin: bool,
                ctx: RenderContext, ray_ids=None):
    """Trace [N] rays under `key` in chunks of params.trace_chunk, passing
    each chunk its global ray ids (ray_ids [N], arange(N) when None). The
    last chunk is padded with rays at the origin along +z, as in the JAX
    package, so every chunk has one shape."""
    N = o.shape[0]
    C = params.trace_chunk
    kw = dict(key=key, accel=ctx.accel, tables=ctx.tables,
              tri_table=ctx.tri_table, shared_origin=shared_origin)
    if N <= C:
        return trace(scene, o, d, features, params, **kw, ray_ids=ray_ids)
    pad = (-N) % C
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype,
                                      device=o.device)])
        dpad = torch.zeros((pad, 3), dtype=d.dtype, device=d.device)
        dpad[:, 2] = 1.0
        d = torch.cat([d, dpad])
    ids = torch.arange(N + pad, dtype=torch.int64, device=o.device)
    if ray_ids is not None:
        ids = torch.cat([ray_ids.to(torch.int64), ids[N:]])
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
    = top. seed: the frame key's seed (the MSAA jitter, the DoF disk and
    the light samples draw from it)."""
    check_supported(params)
    if ctx is None:
        ctx = prepare_render(scene, features, params)
    key = rng.prng_key(seed)
    grid = pixel_grid(width, height, scene.device).reshape(-1, 2)
    tiled = width % 32 == 0 and height % 16 == 0
    if tiled:
        grid = _swizzle_rows(grid, width, height)
    else:
        swizzle, unswizzle = _tile_swizzle(width, height)
        grid = grid[torch.from_numpy(swizzle).to(grid.device)]
    N = grid.shape[0]
    color_sum = torch.zeros((N, 3), dtype=torch.float32, device=grid.device)
    weight = 0
    if features.enable_multiple_rays_per_pixel:
        n = params.rays_per_pixel_side
        pixel_size = torch.tensor([2.0 / width, 2.0 / height],
                                  dtype=torch.float32, device=grid.device)
        pos = msaa_sample_positions(grid, pixel_size, n,
                                    rng.fold_in(key, 101))
        o, d = camera.generate_rays(pos.reshape(-1, 2))
        col = _trace_rays(scene, o, d, features, params,
                          rng.fold_in(key, 1), shared_origin=True, ctx=ctx)
        color_sum = color_sum + fp32.div(col.reshape(N, n * n, 3).sum(dim=1),
                                         float(n * n))
        weight += 1
    if features.enable_depth_of_field:
        n = params.samples_dof
        o, d = dof_rays(grid, camera, params.focus_plane_distance,
                        params.blur_strength, n, rng.fold_in(key, 202))
        col = _trace_rays(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                          features, params, rng.fold_in(key, 2),
                          shared_origin=False, ctx=ctx)
        color_sum = color_sum + fp32.div(col.reshape(N, n, 3).sum(dim=1),
                                         float(n)) * 3.0
        weight += 3
    if not (features.enable_multiple_rays_per_pixel
            or features.enable_depth_of_field):
        o, d = camera.generate_rays(grid)
        col = _trace_rays(scene, o, d, features, params,
                          rng.fold_in(key, 3), shared_origin=True, ctx=ctx)
        color_sum = color_sum + col
        weight += 1
    final = fp32.div(color_sum, float(weight))
    if tiled:
        final = _unswizzle_rows(final, width, height)
    else:
        final = final[torch.from_numpy(unswizzle).to(final.device)]
    buffer = torch.flip(final.reshape(height, width, 3), dims=(0,))
    if features.enable_bloom_effect:
        buffer = render_bloom_filter(buffer, params)
    return buffer


def _to_u8(img):
    """Screen::writeBitmapToFile's quantization (screen.cpp:49-60), on the
    device: NaN -> 0, clamp to [0, 1], x255, truncate to u8."""
    return (torch.nan_to_num(img).clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def render_image_u8(scene, camera: Camera, features: Features,
                    params: RenderParams, width: int, height: int,
                    seed: int = 0,
                    ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """render_image quantized on the device (_to_u8)."""
    return _to_u8(render_image(scene, camera, features, params, width,
                               height, seed, ctx))


def stack_cameras(cameras) -> tuple:
    """The cameras of a batch for render_images. The port's Camera holds
    Python floats, so the batch is a tuple of cameras (the JAX package
    stacks its Camera pytree along a leading axis)."""
    return tuple(cameras)


@torch.no_grad()
def render_images(scene, cameras, features: Features, params: RenderParams,
                  width: int, height: int, seed: int = 0,
                  ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """[C, height, width, 3] f32: camera i of the batch rendered with seed
    seed + i through one RenderContext, one camera after another, as the
    JAX package's lax.map over cameras does (cge_tpu/render/renderer.py:
    210-237)."""
    if ctx is None:
        ctx = prepare_render(scene, features, params)
    return torch.stack([render_image(scene, cam, features, params, width,
                                     height, seed + i, ctx)
                        for i, cam in enumerate(cameras)])


def render_images_u8(scene, cameras, features: Features,
                     params: RenderParams, width: int, height: int,
                     seed: int = 0,
                     ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """render_images quantized on the device: [C, height, width, 3] u8."""
    return _to_u8(render_images(scene, cameras, features, params, width,
                                height, seed, ctx))
