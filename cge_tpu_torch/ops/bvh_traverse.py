"""The reference-parity BVH traversal (counterpart of
cge_tpu/ops/bvh_traverse.py:37-201).

BoundingVolumeHierarchy::intersect with the accel on (the reference's
src/bounding_volume_hierarchy.cpp:299-362):

  - a stack seeded with the root; children are pushed left, then right,
    so the right subtree is visited first (cpp:356-357);
  - the child box tests run at ray.t = FLT_MAX, so the walk never prunes
    by the closest hit so far (cpp:334-352), with FLT_MIN / FLT_MAX in
    place of the slab distances of a zero direction component;
  - a leaf runs its primitives in order and the last accepted hit wins:
    triangles accept 0 <= t <= ray.t, spheres strictly t < ray.t
    (getIntersecting, cpp:272-293).

The JAX package runs one ray per lane of a vmapped lax.while_loop. Here
every lane carries its own [R, STACK] int32 stack, stack pointer and leaf
cursor as tensors, and each step advances every unfinished lane by one
node or one primitive in torch ops. Every STEPS_PER_SYNC steps the
finished lanes are written out and dropped, at one device sync. The
arithmetic takes ops/fp32.py's forms, so the card and the CPU give the
same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cge_tpu_torch.ops import fp32
from cge_tpu_torch.ops.bvh import to_numpy
from cge_tpu_torch.ops.intersect import slab_hit

STACK = 24            # depth <= 16, so sp <= 17
STEPS_PER_SYNC = 8    # lane steps between the checks for finished lanes


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """A ReferenceBVH (ops/bvh.py) as tensors on one device, with the
    permuted primitives inlined: triangle planes and corners, sphere
    centres and radii."""

    node_lo: torch.Tensor       # [N, 3] f32
    node_hi: torch.Tensor       # [N, 3] f32
    node_meta: torch.Tensor     # [N, 6] i64: is_leaf, depth, beg, end, l, r
    root: int
    prim_v0: torch.Tensor       # [P, 3]
    prim_v1: torch.Tensor
    prim_v2: torch.Tensor
    prim_n: torch.Tensor        # [P, 3] unit plane normal (NaN: degenerate)
    prim_D: torch.Tensor        # [P] plane offset dot(n, v0)
    prim_is_sphere: torch.Tensor  # [P] bool
    prim_sph_center: torch.Tensor  # [P, 3]
    prim_sph_radius: torch.Tensor  # [P]
    prim_index: torch.Tensor    # [P] i64 scene ids



def device_bvh(bvh, scene) -> DeviceBVH:
    """Pack a host-built ReferenceBVH for traversal on the scene's
    device."""
    dev = scene.device
    tris = to_numpy(scene.tris)
    verts = to_numpy(scene.vertices)
    idx = np.asarray(bvh.perm_index)
    is_sph = np.asarray(bvh.perm_is_sphere)
    corners = verts[tris[np.where(is_sph, 0, idx)]]          # [P, 3, 3]
    sph_ids = np.where(is_sph, idx, 0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    v0, v1, v2 = (t(corners[:, k]) for k in range(3))
    n = fp32.cross(v1 - v0, v2 - v0)
    n = n / fp32.sqrt_rn(fp32.dot3(n, n))[:, None]
    return DeviceBVH(
        node_lo=t(bvh.node_lo), node_hi=t(bvh.node_hi),
        node_meta=t(bvh.node_meta, torch.int64), root=int(bvh.root),
        prim_v0=v0, prim_v1=v1, prim_v2=v2, prim_n=n,
        prim_D=fp32.dot3(n, v0),
        prim_is_sphere=t(is_sph, torch.bool),
        prim_sph_center=t(to_numpy(scene.sph_center)[sph_ids]),
        prim_sph_radius=t(to_numpy(scene.sph_radius)[sph_ids]),
        prim_index=t(idx, torch.int64))


def _prim_t(bvh: DeviceBVH, p, o, d, ray_t):
    """Primitive p of each lane against its ray under the budget ray_t:
    (accepted, t). Triangles: the plane t in [0, ray_t], finite, and the
    three edge tests; spheres: the a == 1 quadratic's smallest
    non-negative root, strictly below ray_t."""
    v0, v1, v2 = bvh.prim_v0[p], bvh.prim_v1[p], bvh.prim_v2[p]
    n = bvh.prim_n[p]
    t = (bvh.prim_D[p] - fp32.dot3(n, o)) / fp32.dot3(n, d)
    q = o + t[:, None] * d
    inside = ((fp32.dot3(fp32.cross(v1 - v0, q - v0), n) >= 0)
              & (fp32.dot3(fp32.cross(v2 - v1, q - v1), n) >= 0)
              & (fp32.dot3(fp32.cross(v0 - v2, q - v2), n) >= 0))
    tri_ok = (t >= 0) & (t <= ray_t) & inside & torch.isfinite(t)

    oc = o - bvh.prim_sph_center[p]
    r = bvh.prim_sph_radius[p]
    b = 2.0 * fp32.dot3(d, oc)
    disc = b * b - 4.0 * (fp32.dot3(oc, oc) - r * r)
    sq = fp32.sqrt_rn(disc.clamp_min(0.0))
    t0 = (-b - sq) / 2.0
    ts = torch.where(t0 >= 0, t0, (-b + sq) / 2.0)
    sph_ok = (disc >= 0) & (ts >= 0) & (ts < ray_t)

    sph = bvh.prim_is_sphere[p]
    return torch.where(sph, sph_ok, tri_ok), torch.where(sph, ts, t)


def _step(bvh: DeviceBVH, s: dict) -> None:
    """Advance every lane of the state s by one primitive (a lane inside a
    leaf) or one popped node (a lane with a non-empty stack)."""
    o, d, cur, end, sp, stack = (s["o"], s["d"], s["cur"], s["end"],
                                 s["sp"], s["stack"])
    in_leaf = cur < end
    P = bvh.prim_index.shape[0]
    hit, t = _prim_t(bvh, cur.clamp(0, P - 1), o, d, s["best_t"])
    take = in_leaf & hit
    s["best_t"] = torch.where(take, t, s["best_t"])
    s["best_p"] = torch.where(take, cur, s["best_p"])

    pop = ~in_leaf & (sp > 0)
    sp = sp - pop.long()
    node = stack.gather(1, sp.clamp_min(0)[:, None])[:, 0]
    meta = bvh.node_meta[node.long()]
    is_leaf = meta[:, 0] == 1
    opens = pop & is_leaf
    s["cur"] = torch.where(in_leaf, cur + 1, torch.where(opens, meta[:, 2],
                                                         cur))
    s["end"] = torch.where(opens, meta[:, 3], end)
    internal = pop & ~is_leaf
    for child in (meta[:, 4], meta[:, 5]):          # left, then right
        c = child.clamp_min(0)
        # the child box at ray.t = FLT_MAX (cpp:334-352): no budget test
        push = internal & slab_hit(o, d, bvh.node_lo[c], bvh.node_hi[c])[0]
        slot = sp[:, None]
        stack.scatter_(1, slot, torch.where(push[:, None],
                                            c[:, None].to(stack.dtype),
                                            stack.gather(1, slot)))
        sp = sp + push.long()
    s["sp"] = sp


@torch.no_grad()
def bvh_closest_hit(bvh: DeviceBVH, o, d, tmax):
    """The batched reference traversal. o, d: [R, 3]; tmax: [R], the
    incoming ray.t budget (inf for a closest hit, 1.0 for the reference's
    shadow rays; a dead ray may pass -1). Returns (hit [R] bool, t [R],
    inf on a miss, is_sphere [R], prim [R] i64 scene ids)."""
    R = o.shape[0]
    dev = o.device
    out_t = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    out_p = torch.full((R,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK), dtype=torch.int32, device=dev)
    stack[:, 0] = bvh.root
    zeros = torch.zeros(R, dtype=torch.int64, device=dev)
    s = dict(o=o.float(), d=d.float(), best_t=tmax.float().clone(),
             best_p=torch.full((R,), -1, dtype=torch.int64, device=dev),
             cur=zeros, end=zeros.clone(), sp=torch.ones_like(zeros),
             stack=stack, lane=torch.arange(R, device=dev))
    while s["lane"].numel():
        for _ in range(STEPS_PER_SYNC):
            _step(bvh, s)
        done = ~((s["sp"] > 0) | (s["cur"] < s["end"]))
        if bool(done.any()):
            lanes = s["lane"][done]
            out_t[lanes] = s["best_t"][done]
            out_p[lanes] = s["best_p"][done]
            s = {k: v[~done] for k, v in s.items()}
    found = out_p >= 0
    safe = out_p.clamp_min(0)
    return (found, torch.where(found, out_t, torch.inf),
            found & bvh.prim_is_sphere[safe],
            torch.where(found, bvh.prim_index[safe], 0))
