"""Cluster accel builder (counterpart of cge_tpu/ops/bvh.py:282-332).

Host-side numpy, run once per scene: triangles are permuted into
spatially-coherent clusters of CLUSTER_SIZE by largest-extent median splits.
The split lands on the cluster-size multiple nearest the median, so every
left descendant fills its cluster. Member order inside a cluster follows
`np.argpartition`, which may differ from the JAX package's native builder
(`std::nth_element`); the clusters hold the same triangles.
"""

from __future__ import annotations

import numpy as np

CLUSTER_SIZE = 128   # triangles per cluster tile


def build_clusters(vertices, tris, tri_mask,
                   cluster_size: int = CLUSTER_SIZE) -> np.ndarray:
    """Returns perm: [L, cluster_size] int32 triangle ids, -1 padded.
    Cluster order follows the recursion (children adjacent)."""
    v = np.asarray(vertices)
    t = np.asarray(tris)
    mask = np.asarray(tri_mask)
    ids = np.nonzero(mask)[0].astype(np.int32)
    if len(ids) == 0:
        return np.full((1, cluster_size), -1, np.int32)
    centers = v[t[ids]].mean(axis=1)

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
