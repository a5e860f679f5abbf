"""Mesh axes and collectives of the sharded entry points.

The JAX package names a mesh axis inside `shard_map` and its sweeps call
`jax.lax.axis_index` and `all_gather` on that name. Here the sharded entry
points (parallel.sharding) bind their `DeviceMesh` for the duration of a
call (`bind_mesh`), and the code below them resolves an axis name to the
axis's process group, this rank's coordinate on it and its size
(`mesh_axis`). The sweeps stay free of mesh plumbing: they carry only the
axis name that `RenderParams.prims_axis` gives them. Outside a bound mesh
an axis name resolves to nothing and raises.

The two collectives the port runs go through `all_gather` and
`all_reduce_mean` here, which count their calls, payload bytes and
milliseconds in `COLLECTIVES`. Each synchronizes a CUDA device before and
after the collective, so the milliseconds are the collective's own.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch
import torch.distributed as dist

# calls, payload bytes (the gathered output; the reduced input) and host
# milliseconds of the collectives, summed over the process's calls
COLLECTIVES = {"calls": 0, "bytes": 0, "ms": 0.0}


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the bound mesh, as this rank sees it."""

    name: str
    group: dist.ProcessGroup
    index: int       # this rank's coordinate on the axis
    size: int


_AXES: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "cge_tpu_torch_mesh_axes", default={})


@contextlib.contextmanager
def bind_mesh(mesh):
    """Make the axes of `mesh` (a torch DeviceMesh with mesh_dim_names)
    resolvable by name inside the block."""
    axes = {name: MeshAxis(name, mesh.get_group(name),
                           mesh.get_local_rank(name), mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}
    token = _AXES.set(axes)
    try:
        yield axes
    finally:
        _AXES.reset(token)


def mesh_axis(name: str) -> MeshAxis:
    """The bound mesh's axis `name`; ValueError when no sharded entry point
    has bound a mesh with that axis."""
    axes = _AXES.get()
    if name not in axes:
        raise ValueError(
            f"mesh axis {name!r} is not bound: prims_axis renders only "
            f"inside a sharded entry point (cge_tpu_torch.parallel), whose "
            f"mesh names the axis; bound axes: {sorted(axes)}")
    return axes[name]


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _count(x: torch.Tensor, nbytes: int, t0: float) -> None:
    _sync(x)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += nbytes
    COLLECTIVES["ms"] += (time.perf_counter() - t0) * 1e3


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[P, *x.shape]: x of every rank of `group`, in rank order on the
    group. Both backends take the tensor where it lies: NCCL on the card,
    gloo on the CPU or the card (gloo stages a CUDA tensor through the
    host itself; both checked on the card, torch 2.11)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _sync(x)
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts)
    _count(x, out.numel() * out.element_size(), t0)
    return out


def all_reduce_mean(tensors: list, group=None) -> list:
    """The mean over the ranks of `group` (None: the world) of each tensor
    (SUM, then a divide by the group's size, as JAX's pmean), as one
    all-reduce of the flattened float32 tensors, where they lie."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _sync(flat)
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    _count(flat, flat.numel() * flat.element_size(), t0)
    buf = flat / dist.get_world_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out
