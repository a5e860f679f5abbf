"""Multi-device render and train step on torch.distributed (counterpart of
cge_tpu/parallel/sharding.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimension
names are the JAX mesh's axis names:

  - 'rays' (data parallel): the flat ray batch is padded with zero rays to
    a multiple of the axis and split into contiguous shards; the scene is
    replicated and each rank traces its shard with GLOBAL ray ids
    (rays_coord * nl + arange(nl)), which key every threefry stream, so a
    sharded trace draws exactly the single-device samples;
  - 'prims' (tensor parallel, optional): each rank sweeps a slice of the
    clusters or of the triangle table and the partial hits meet in an
    all-gather and a tie-aware reduction (ops.intersect.closest_hit with
    RenderParams.prims_axis = 'prims');
  - the train step all-reduces the loss and every gradient over the whole
    mesh (SUM / world size: JAX's pmean over every axis).

Each entry point runs in every rank of the mesh (SPMD, one process a rank)
and returns the whole batch on every rank: the shards are all-gathered over
the 'rays' axis and cut back to n, the counterpart of reading JAX's global
array. The mesh spans the world of the default process group. The
collectives go through parallel.comm, which counts them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cge_tpu_torch.camera import Camera, pixel_grid
from cge_tpu_torch.diff.gradients import loss_and_grads, sgd_step
from cge_tpu_torch.ops import rng
from cge_tpu_torch.parallel import comm
from cge_tpu_torch.render.renderer import (RenderContext, _swizzle_rows,
                                           _tile_swizzle, _trace_rays,
                                           _unswizzle_rows, prepare_render)
from cge_tpu_torch.types import Features, RenderParams


def init_distributed(backend: str | None = None, **kw) -> None:
    """Join the default process group (torch.distributed.
    init_process_group with `backend` and kw: init_method, world_size,
    rank, ...). Call once per process before make_mesh. NCCL takes one
    rank a card; several ranks on one card need gloo."""
    dist.init_process_group(backend=backend, **kw)


def make_mesh(axes=("rays",), shape: Optional[tuple] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh over the world with the JAX mesh's axis names. Default:
    every rank on one 'rays' axis. device_type: "cuda" (the card) or
    "cpu"."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _pad_to(x, mult: int):
    """x padded with zero rows to a multiple of mult, and its length."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]), n


def _prims_params(scene, params: RenderParams, mesh) -> RenderParams:
    """params with prims_axis = 'prims' where the mesh shards triangles."""
    names = mesh.mesh_dim_names
    if "prims" not in names:
        return params
    P = mesh.size(names.index("prims"))
    if P == 1:
        return params
    T = scene.tris.shape[0]
    if T % P:
        raise ValueError(f"the triangle table ({T} rows) must split evenly "
                         f"over the prims axis ({P})")
    return params.replace(prims_axis="prims", prims_axis_size=P)


def _shard(mesh, n_padded: int):
    """(the 'rays' axis's group, this rank's slice of a padded batch)."""
    names = mesh.mesh_dim_names
    R = mesh.size(names.index("rays"))
    c = mesh.get_local_rank("rays")
    nl = n_padded // R
    return mesh.get_group("rays"), slice(c * nl, (c + 1) * nl)


def _trace_shards(scene, o, d, ids, features, params, mesh, key,
                  shared_origin: bool, ctx):
    """The rays [n] with their global ids, padded with zero rays to a
    multiple of the 'rays' axis; this rank's shard traced in chunks of
    params.trace_chunk with the mesh bound; the shards all-gathered over
    'rays' and cut back to n."""
    R = mesh.size(mesh.mesh_dim_names.index("rays"))
    o, n = _pad_to(o, R)
    d, _ = _pad_to(d, R)
    ids = torch.cat([ids, torch.arange(n, o.shape[0], dtype=ids.dtype,
                                       device=ids.device)])
    group, sl = _shard(mesh, o.shape[0])
    params = _prims_params(scene, params, mesh)
    with comm.bind_mesh(mesh):
        if ctx is None:
            ctx = prepare_render(scene, features, params)
        col = _trace_rays(scene, o[sl], d[sl], features, params, key,
                          shared_origin, ctx, ray_ids=ids[sl])
        return comm.all_gather(col, group).reshape(-1, 3)[:n]


@torch.no_grad()
def trace_sharded(scene, o, d, features: Features, params: RenderParams,
                  mesh, seed: int = 0,
                  ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """Trace a flat [n] ray batch sharded over the mesh's 'rays' axis (and
    with the triangle sweep sharded over 'prims' where that axis has more
    than one rank) under prng_key(seed); ray i has global id i. Each shard
    runs in chunks of params.trace_chunk. Returns the radiance [n, 3] of
    the whole batch on every rank. ctx: prepare_render's state, built here
    when None."""
    ids = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    return _trace_shards(scene, o, d, ids, features, params, mesh,
                         rng.prng_key(seed), False, ctx)


@torch.no_grad()
def render_image_sharded(scene, camera: Camera, features: Features,
                         params: RenderParams, width: int, height: int,
                         mesh, seed: int = 0,
                         ctx: Optional[RenderContext] = None) -> torch.Tensor:
    """The single-sample render [height, width, 3], row 0 = top, sharded
    as trace_sharded, on every rank. As in the JAX package the MSAA, DoF
    and bloom flags are not applied here. Pixel p (in scan order) keeps
    the global id p and the frame key prng_key(seed), as JAX's
    render_image_sharded gives it; the pixels are traced in render_image's
    32x16 screen-tile order, so where params.trace_chunk divides a shard,
    every chunk holds the rays of a chunk of render_image."""
    grid = pixel_grid(width, height, scene.device).reshape(-1, 2)
    ids = torch.arange(width * height, dtype=torch.int64,
                       device=grid.device)
    tiled = width % 32 == 0 and height % 16 == 0
    if tiled:
        grid = _swizzle_rows(grid, width, height)
        ids = _swizzle_rows(ids[:, None], width, height)[:, 0]
    else:
        swizzle, unswizzle = _tile_swizzle(width, height)
        swizzle = torch.from_numpy(swizzle).to(grid.device)
        grid, ids = grid[swizzle], ids[swizzle]
    o, d = camera.generate_rays(grid)
    col = _trace_shards(scene, o, d, ids, features, params, mesh,
                        rng.prng_key(seed), True, ctx)
    col = (_unswizzle_rows(col, width, height) if tiled
           else col[torch.from_numpy(unswizzle).to(col.device)])
    return torch.flip(col.reshape(height, width, 3), dims=(0,))


def loss_and_grads_sharded(scene, o, d, target, features: Features,
                           params: RenderParams, mesh, seed: int = 0):
    """(loss, {field: gradient}) of the sharded step, on every rank: the
    rays and target rows over 'rays' (both padded with zeros to a multiple
    of the axis; pad rays count in each shard's mean, as in JAX), the
    triangle sweep over 'prims' where present. Each rank takes
    loss_and_grads of its shard with global ray ids; the loss and every
    gradient are averaged over the whole mesh in one all-reduce (JAX's
    pmean over every axis). The sweeps' hit selection has no gradient, so
    the backward runs no collective."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh.size()} ranks, the world "
                         f"{dist.get_world_size()}: the step averages "
                         f"over the world")
    R = mesh.size(mesh.mesh_dim_names.index("rays"))
    o_p, _ = _pad_to(o, R)
    d_p, _ = _pad_to(d, R)
    t_p, _ = _pad_to(target, R)
    _, sl = _shard(mesh, o_p.shape[0])
    ids = torch.arange(o_p.shape[0], dtype=torch.int64,
                       device=o.device)[sl]
    params = _prims_params(scene, params, mesh)
    with comm.bind_mesh(mesh):
        loss, grads = loss_and_grads(scene, o_p[sl], d_p[sl], t_p[sl],
                                     features, params, seed, ray_ids=ids)
    names = list(grads)
    loss, *flat = comm.all_reduce_mean([loss] + [grads[k] for k in names])
    return loss, dict(zip(names, flat))


def train_step_sharded(scene, o, d, target, features: Features,
                       params: RenderParams, mesh, lr: float = 1e-3,
                       seed: int = 0):
    """One differentiable-render SGD step, sharded (counterpart of JAX's
    train_step_sharded): loss_and_grads_sharded, then sgd_step, which
    recomputes the host flags. Returns (loss, new_scene) on every rank."""
    loss, grads = loss_and_grads_sharded(scene, o, d, target, features,
                                         params, mesh, seed)
    return loss, sgd_step(scene, grads, lr)
