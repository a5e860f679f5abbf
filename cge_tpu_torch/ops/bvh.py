"""Bounding volume hierarchies (counterpart of cge_tpu/ops/bvh.py).

Two structures, both built host-side in numpy once per scene:

1. The reference-parity BVH (`build_reference_bvh`, cge_tpu/ops/bvh.py:
   34-280): the reference's construction rules (src/
   bounding_volume_hierarchy.cpp): a median split by nth_element on axis
   depth % 3, or SAH binning (a full sort per axis, at most NUM_OF_BINS
   stride-sampled candidate splits, cost SA_L * n_L + SA_R * n_R); a leaf
   at depth MAX_DEPTH - 1 or with one primitive; primitives are every
   mesh triangle, then every sphere. The debug views read it, and
   ops/bvh_traverse.py walks it.

2. The cluster accel (`build_clusters`, cge_tpu/ops/bvh.py:282-332):
   triangles permuted into spatially-coherent clusters of CLUSTER_SIZE by
   largest-extent median splits. The split lands on the cluster-size
   multiple nearest the median, so every left descendant fills its
   cluster.

Both default to the native host library (cge_tpu_torch.native, its
`std::nth_element` splits), as the JAX package does, so the default
cluster perm and BVH are the JAX defaults'. `use_native=False` runs the
numpy twins here, node for node the JAX package's pure-Python builders:
their splits follow `np.argpartition`, so members come in another order,
and where a split plane cuts through equal centres the tied ones may
land on the other side (the same node and cluster sizes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_DEPTH = 16       # bounding_volume_hierarchy.h:43
NUM_OF_BINS = 8      # bounding_volume_hierarchy.h:44
CLUSTER_SIZE = 128   # triangles per cluster tile


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)



def _primitive_soup(scene):
    """The scene's valid primitives in the reference's order, every mesh
    triangle (centroid: the mean of its corners) and then every sphere
    (its centre): (lo, hi, center, is_sphere, prim_index)."""
    v = to_numpy(scene.vertices)
    t = to_numpy(scene.tris)
    mask = to_numpy(scene.tri_mask)
    tv = v[t[mask]]                       # [Tv, 3, 3]
    lo = tv.min(axis=1)
    hi = tv.max(axis=1)
    center = tv.mean(axis=1, dtype=np.float32)
    idx = np.nonzero(mask)[0].astype(np.int32)
    is_sphere = np.zeros(len(idx), bool)

    smask = to_numpy(scene.sph_mask)
    if smask.any():
        sc = to_numpy(scene.sph_center)[smask]
        sr = to_numpy(scene.sph_radius)[smask][:, None]
        lo = np.concatenate([lo, sc - sr])
        hi = np.concatenate([hi, sc + sr])
        center = np.concatenate([center, sc.astype(np.float32)])
        idx = np.concatenate([idx, np.nonzero(smask)[0].astype(np.int32)])
        is_sphere = np.concatenate([is_sphere, np.ones(smask.sum(), bool)])
    return lo.astype(np.float32), hi.astype(np.float32), center, is_sphere, idx


def _surface_area(lo, hi):
    e = hi - lo
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


@dataclasses.dataclass
class SAHCuts:
    """The candidate SAH split planes of one internal node (SAHCuts,
    bounding_volume_hierarchy.h:25-29): per axis, each candidate plane as
    the parent box flattened at the cut coordinate (getSplitPlane, cpp:
    91-96), and which (axis, index) won."""

    cuts: list                # 3 lists of (lo [3], hi [3]) plane boxes
    chosen_dim: int
    chosen_ind: int


@dataclasses.dataclass
class ReferenceBVH:
    """The linearised reference-rule BVH. node_meta's columns follow the
    reference's Node.data (bounding_volume_hierarchy.h:31-41): is_leaf,
    depth, beg, end, left, right, over the permuted primitive order."""

    node_lo: np.ndarray       # [N, 3] f32
    node_hi: np.ndarray       # [N, 3] f32
    node_meta: np.ndarray     # [N, 6] i32
    root: int
    perm_is_sphere: np.ndarray  # [P] bool, permuted primitive kinds
    perm_index: np.ndarray      # [P] i32, permuted primitive scene ids
    num_levels: int
    num_leaves: int
    max_per_leaf: int
    # per-depth SAHCuts lists (sahCutsPerLevel, h:91): SAH builds with
    # record_sah_cuts=True only
    sah_cuts_per_level: list | None = None

    def debug_level_boxes(self, level: int):
        """The boxes of every node at depth `level` (debugDrawLevel, cpp:
        221-228): (lo [K, 3], hi [K, 3])."""
        sel = self.node_meta[:, 1] == level
        return self.node_lo[sel], self.node_hi[sel]

    def debug_leaf(self, leaf_idx: int):
        """The box and primitives of the leaf_idx-th leaf in node order,
        1-based like the UI slider (debugDrawLeaf, cpp:244-270): (lo, hi,
        scene ids, is_sphere), or None."""
        count = 0
        for n in range(len(self.node_meta)):
            if self.node_meta[n, 0]:
                count += 1
                if count == leaf_idx:
                    beg, end = self.node_meta[n, 2], self.node_meta[n, 3]
                    return (self.node_lo[n], self.node_hi[n],
                            self.perm_index[beg:end],
                            self.perm_is_sphere[beg:end])
        return None

    def debug_sah_splits(self, level: int, axis: int):
        """The candidate SAH planes of every node at `level` along `axis`
        (debugDrawSAHSplits, cpp:230-237), each a flattened box, the
        node's chosen one flagged: (lo [K, 3], hi [K, 3], chosen [K]).
        Needs a build with record_sah_cuts=True."""
        if self.sah_cuts_per_level is None:
            raise ValueError("build with sah_binning=True, "
                             "record_sah_cuts=True to record split planes")
        los, his, chosen = [], [], []
        if 0 <= level < len(self.sah_cuts_per_level):
            for sc in self.sah_cuts_per_level[level]:
                for i, (lo, hi) in enumerate(sc.cuts[axis]):
                    los.append(lo)
                    his.append(hi)
                    chosen.append(sc.chosen_dim == axis
                                  and sc.chosen_ind == i)
        if not los:
            z = np.zeros((0, 3), np.float32)
            return z, z, np.zeros(0, bool)
        return (np.asarray(los, np.float32), np.asarray(his, np.float32),
                np.asarray(chosen, bool))


def build_reference_bvh(scene, sah_binning: bool = False,
                        use_native: bool = True,
                        record_sah_cuts: bool = False) -> ReferenceBVH:
    """The reference BVH of the scene (any device's SceneArrays; built on
    the host). sah_binning picks SAH binning over the median split;
    use_native the native builder over the numpy twin; record_sah_cuts
    keeps every SAH node's candidate planes (the numpy twin only, as in
    the JAX package)."""
    lo, hi, center, is_sphere, prim_idx = _primitive_soup(scene)
    if use_native and not record_sah_cuts:
        from cge_tpu_torch import native

        node_lo, node_hi, node_meta, perm, (levels, leaves, mx) = \
            native.build_bvh(lo, hi, center, sah_binning)
        return ReferenceBVH(
            node_lo=node_lo, node_hi=node_hi, node_meta=node_meta,
            root=len(node_meta) - 1, perm_is_sphere=is_sphere[perm],
            perm_index=prim_idx[perm], num_levels=levels, num_leaves=leaves,
            max_per_leaf=mx)
    order = np.arange(len(center))
    node_lo, node_hi, node_meta = [], [], []
    stats = dict(levels=0, leaves=0, max_leaf=0)
    sah_cuts_per_level: list | None = [] if record_sah_cuts else None

    def bbox(beg, end):
        sel = order[beg:end]
        return lo[sel].min(axis=0), hi[sel].max(axis=0)

    def split_standard(beg, end, depth):
        axis = depth % 3
        mid = beg + (end - beg) // 2
        sel = order[beg:end]
        part = np.argpartition(center[sel, axis], mid - beg)
        order[beg:end] = sel[part]
        return mid

    def split_sah(beg, end, depth):
        skip = max(1, (end - beg) // NUM_OF_BINS)
        best_cost = np.inf
        best_split, best_axis = None, None
        if record_sah_cuts:
            while len(sah_cuts_per_level) <= depth:    # cpp:133-135
                sah_cuts_per_level.append([])
            rec = SAHCuts(cuts=[[], [], []], chosen_dim=0, chosen_ind=0)
            plo, phi = bbox(beg, end)                  # parentBox (cpp:102)
        for axis in range(3):
            sel = order[beg:end]
            srt = sel[np.argsort(center[sel, axis], kind="stable")]
            order[beg:end] = srt
            clo = lo[srt]
            chi = hi[srt]
            # prefix / suffix bounds: every candidate's cost in O(n)
            pre_lo = np.minimum.accumulate(clo, axis=0)
            pre_hi = np.maximum.accumulate(chi, axis=0)
            suf_lo = np.minimum.accumulate(clo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(chi[::-1], axis=0)[::-1]
            for split in range(beg + skip, end, skip):
                k = split - beg
                if record_sah_cuts:
                    # the parent box flattened halfway between the two
                    # sorted centres at the cut (getSplitPlane, cpp:91-96)
                    cut = 0.5 * (center[srt[k], axis]
                                 + center[srt[k - 1], axis])
                    cl, ch = plo.copy(), phi.copy()
                    cl[axis] = ch[axis] = cut
                    rec.cuts[axis].append((cl, ch))
                cost = (_surface_area(pre_lo[k - 1], pre_hi[k - 1]) * k
                        + _surface_area(suf_lo[k], suf_hi[k])
                        * (end - split))
                if cost < best_cost:
                    best_cost, best_split, best_axis = cost, split, axis
                    if record_sah_cuts:
                        rec.chosen_dim = axis
                        rec.chosen_ind = len(rec.cuts[axis]) - 1
        if record_sah_cuts:
            sah_cuts_per_level[depth].append(rec)      # cpp:124
        sel = order[beg:end]
        srt = sel[np.argsort(center[sel, best_axis], kind="stable")]
        order[beg:end] = srt
        return best_split

    split = split_sah if sah_binning else split_standard

    def create(beg, end, depth):
        """Children before their parent: post-order node ids."""
        stats["levels"] = max(stats["levels"], depth + 1)
        blo, bhi = bbox(beg, end)
        if depth + 1 == MAX_DEPTH or beg + 1 == end:   # cpp:136
            node_lo.append(blo)
            node_hi.append(bhi)
            node_meta.append([1, depth, beg, end, -1, -1])
            stats["leaves"] += 1
            stats["max_leaf"] = max(stats["max_leaf"], end - beg)
            return len(node_meta) - 1
        mid = split(beg, end, depth)
        left = create(beg, mid, depth + 1)
        right = create(mid, end, depth + 1)
        node_lo.append(blo)
        node_hi.append(bhi)
        node_meta.append([0, depth, beg, end, left, right])
        return len(node_meta) - 1

    root = create(0, len(center), 0)
    return ReferenceBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_meta=np.asarray(node_meta, np.int32),
        root=root,
        perm_is_sphere=is_sphere[order],
        perm_index=prim_idx[order],
        num_levels=stats["levels"],
        num_leaves=stats["leaves"],
        max_per_leaf=stats["max_leaf"],
        sah_cuts_per_level=sah_cuts_per_level,
    )


def build_clusters(vertices, tris, tri_mask,
                   cluster_size: int = CLUSTER_SIZE,
                   use_native: bool = True) -> np.ndarray:
    """Returns perm: [L, cluster_size] int32 triangle ids, -1 padded.
    Cluster order follows the recursion (children adjacent). use_native:
    the native builder, else the numpy twin below."""
    v = to_numpy(vertices)
    t = to_numpy(tris)
    mask = to_numpy(tri_mask)
    ids = np.nonzero(mask)[0].astype(np.int32)
    if len(ids) == 0:
        return np.full((1, cluster_size), -1, np.int32)
    centers = v[t[ids]].mean(axis=1)
    if use_native:
        from cge_tpu_torch import native

        perm = native.build_clusters(centers, cluster_size)
        return np.where(perm >= 0, ids[np.maximum(perm, 0)], -1)

    clusters: list = []
    stack = [np.arange(len(ids))]
    while stack:                       # depth-first, left child first
        positions = stack.pop()
        n = len(positions)
        if n <= cluster_size:
            clusters.append(positions)
            continue
        c = centers[positions]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (n // 2 + cluster_size // 2) // cluster_size * cluster_size
        mid = max(cluster_size, min(mid, (n - 1) // cluster_size
                                    * cluster_size))
        part = np.argpartition(c[:, axis], mid)
        stack.append(positions[part[mid:]])
        stack.append(positions[part[:mid]])

    perm = np.full((len(clusters), cluster_size), -1, np.int32)
    for i, cl in enumerate(clusters):
        perm[i, : len(cl)] = ids[cl]
    return perm
