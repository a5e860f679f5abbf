"""Debug views as arrays and images (counterpart of cge_tpu/viz/debug.py:
31-398).

The reference checks its features with OpenGL overlays (src/draw.cpp,
wired in main.cpp:379-463): coloured debug rays (render.cpp:135-147),
shadow rays coded red or by the light's colour (light.cpp:63-71), vertex
normals (bounding_volume_hierarchy.cpp:388-392) and the BVH's level, leaf,
traversal and SAH overlays. Each becomes a data export (segments and
colours as numpy) and, through draw_segments, an overlay drawn into a
rendered image on the host. The replays run the port's own queries: the
closest hit without an accel (K3 on the card, its twin on the CPU), the
shading and the shadow rays of render/lights.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cge_tpu_torch.camera import Camera, quat_from_euler
from cge_tpu_torch.ops import rng
from cge_tpu_torch.ops.bvh import to_numpy
from cge_tpu_torch.ops.cluster_sweep import FLT_MAX, FLT_MIN
from cge_tpu_torch.ops.intersect import closest_hit
from cge_tpu_torch.ops.shading import compute_reflection_ray
from cge_tpu_torch.ops.sweep import pack_tri_table
from cge_tpu_torch.render.lights import light_contribution, shadow_visibility
from cge_tpu_torch.render.sampling import dof_rays, msaa_sample_positions
from cge_tpu_torch.render.wavefront import hit_attributes, pack_attr_table
from cge_tpu_torch.scene.scene import resolve_device

_RED = np.array([1.0, 0.0, 0.0], np.float32)



class DebugRays(NamedTuple):
    """One bounce level of debug rays (drawRay, draw.cpp:212-234: a
    segment from the origin to o + min(t, 100) d and a hit marker)."""

    origin: np.ndarray   # [N, 3]
    dir: np.ndarray      # [N, 3]
    t: np.ndarray        # [N], 100 on a miss, as drawRay clamps
    hit: np.ndarray      # [N] bool
    color: np.ndarray    # [N, 3]: the shading on a hit (white with shading
                         # off), red on a miss (render.cpp:135-147)


@torch.no_grad()
def debug_trace(scene, o, d, features, params, key=None, depth=None):
    """Replay the bounce recursion of a few rays through every level and
    every branch, mirror and transparency continuation (the R-key debug
    ray, main.cpp:90-104 and 391-433, which draws the rays of every
    recursive call). Returns a list of DebugRays, one a level. Children
    follow the feature set's radiance flow: with recursion a mirror ray
    where ks != 0 (render.cpp:100), and where the hit's transparency != 1
    the continuation ray (render.cpp:108-111); with transparency alone
    only the continuation (render.cpp:42-43). Dead branches are dropped
    on the host. key: the light samples' key (ops.rng; prng_key(0) by
    default), level l drawing from fold_in(key, l)."""
    key = rng.prng_key(0) if key is None else key
    depth = params.ray_depth if depth is None else depth
    dev = scene.device
    o = np.atleast_2d(to_numpy(o).astype(np.float32))
    d = np.atleast_2d(to_numpy(d).astype(np.float32))
    tri_table = pack_tri_table(scene.vertices, scene.tris, scene.tri_mask)
    rows = pack_attr_table(scene)
    levels = []
    for level in range(depth + 1):
        ot = torch.from_numpy(o).to(dev)
        dt = torch.from_numpy(d).to(dev)
        tmax = torch.full((o.shape[0],), torch.inf, device=dev)
        ids = closest_hit(scene, ot, dt, tmax, tri_table=tri_table)
        attrs = hit_attributes(scene, ot, dt, ids, features, rows)
        local = light_contribution(scene, ot, dt, attrs.t, attrs.normal,
                                   attrs.kd, attrs.ks, attrs.shininess,
                                   features, params, rng.fold_in(key, level),
                                   tri_table=tri_table)
        hit = to_numpy(attrs.hit)
        t_hit = to_numpy(attrs.t)
        color = (to_numpy(local) if features.enable_shading
                 else np.ones((o.shape[0], 3), np.float32))
        color = np.where(hit[:, None], color, _RED)
        levels.append(DebugRays(origin=o, dir=d,
                                t=np.where(hit, t_hit, np.float32(100.0)),
                                hit=hit, color=color))
        if not hit.any() or level == depth:
            break

        children_o, children_d = [], []
        trans_ne1 = to_numpy(attrs.transparency) != 1.0
        valid_mirror = to_numpy((attrs.ks != 0.0).any(dim=-1))
        if features.enable_recursive:
            mo, md, _ = compute_reflection_ray(ot, dt, attrs.t, attrs.normal,
                                               attrs.ks)
            take = hit & valid_mirror
            children_o.append(to_numpy(mo)[take])
            children_d.append(to_numpy(md)[take])
        if features.enable_transparency or (features.enable_recursive
                                            and trans_ne1.any()):
            co = (1e-5 + t_hit)[:, None] * d + o
            take = hit & trans_ne1
            children_o.append(co[take])
            children_d.append(d[take])
        if not children_o:
            break
        o = np.concatenate(children_o)
        d = np.concatenate(children_d)
        if o.shape[0] == 0:
            break
    return levels


def debug_ray_samples(nx, ny, camera: Camera, params, width=800, height=800,
                      key=None, device=None):
    """The R-key MSAA sample set (main.cpp:95-98): the jittered sub-pixel
    fan at the cursor (nx, ny) in NDC, with the debug pixel size
    window * 0.00005 the reference hard-codes there. key: prng_key(7) by
    default. Returns (o, d) [n^2, 3] on `device` (the card by default)."""
    dev = resolve_device(device)
    key = rng.prng_key(7) if key is None else key
    pixel_size = torch.tensor([width * 0.00005, height * 0.00005],
                              dtype=torch.float32, device=dev)
    grid = torch.tensor([[nx, ny]], dtype=torch.float32, device=dev)
    pos = msaa_sample_positions(grid, pixel_size, params.rays_per_pixel_side,
                                key)
    return camera.generate_rays(pos.reshape(-1, 2))


def debug_dof_rays(nx, ny, camera: Camera, params, key=None, device=None):
    """The R-key DoF sample set (main.cpp:99-100): samples_dof disk-jittered
    origins converging on the focal-plane point of the cursor ray. key:
    prng_key(9) by default. Returns (o, d) [samples_dof, 3] on `device`
    (the card by default)."""
    dev = resolve_device(device)
    key = rng.prng_key(9) if key is None else key
    grid = torch.tensor([[nx, ny]], dtype=torch.float32, device=dev)
    o, d = dof_rays(grid, camera, params.focus_plane_distance,
                    params.blur_strength, params.samples_dof, key)
    return o.reshape(-1, 3), d.reshape(-1, 3)


class ShadowRays(NamedTuple):
    """Shadow rays as the reference draws them (light.cpp:63-71): from the
    shaded point to each light sample, red where blocked, the light's
    colour where visible."""

    origin: np.ndarray       # [N, 3] shaded points
    target: np.ndarray       # [N, 3] light sample positions
    visible: np.ndarray      # [N] f32 in [0, 1]
    color: np.ndarray        # [N, 3]


@torch.no_grad()
def debug_shadow_rays(scene, ray_o, ray_d, ray_t, sample_pos, sample_color,
                      features, params) -> ShadowRays:
    """The shadow rays of shaded rays (tensors on the scene's device)
    toward one light sample each."""
    vis = to_numpy(shadow_visibility(scene, ray_o, ray_d, ray_t, sample_pos,
                                features, params))
    o, dd, t = to_numpy(ray_o), to_numpy(ray_d), to_numpy(ray_t)
    dlen = np.linalg.norm(dd, axis=-1, keepdims=True)
    p = o + dd / dlen * (t * dlen[..., 0] - 1e-5)[..., None]
    color = np.where(vis[:, None] > 0, to_numpy(sample_color), _RED)
    return ShadowRays(origin=p, target=to_numpy(sample_pos), visible=vis,
                      color=color)


class TraversalDebug(NamedTuple):
    """What the debugBVHTraversal overlay draws for one ray (bounding_
    volume_hierarchy.cpp:338-360): the children whose box passed the test
    as the walk reached their parent (grey there), the internal nodes
    whose children both missed (red there), and the winning primitive's
    corners (debugDrawTriangle, cpp:376-378; None on a miss or a sphere).
    Depths let a view filter by level (see app/state.py for the
    reference's level gate)."""

    visited_lo: np.ndarray     # [K, 3]
    visited_hi: np.ndarray     # [K, 3]
    visited_depth: np.ndarray  # [K] i32, depth of the drawn child
    dead_lo: np.ndarray        # [M, 3]
    dead_hi: np.ndarray        # [M, 3]
    dead_depth: np.ndarray     # [M] i32
    tri: np.ndarray | None     # [3, 3] or None


def _aabb_hit_host(o, d, lo, hi):
    """The traversal's child box test at ray.t = FLT_MAX (cpp:334-352),
    one ray on the host (ops/bvh_traverse.py's, in numpy)."""
    zero = d == 0
    safe_d = np.where(zero, 1.0, d)
    t_l = np.where(zero, np.float32(FLT_MIN), (lo - o) / safe_d)
    t_u = np.where(zero, np.float32(FLT_MAX), (hi - o) / safe_d)
    tnear = np.minimum(t_l, t_u).max()
    tfar = np.maximum(t_l, t_u).min()
    if tnear < 0:
        ok, t = tfar > 0, tfar
    else:
        ok, t = tnear <= tfar, tnear
    return bool(ok and t >= 0)


def traversal_debug(bvh, scene, o, d) -> TraversalDebug:
    """Replay the reference's stack walk (cpp:312-362) for one ray on the
    host, recording what the GL debugger would draw. bvh: a ReferenceBVH
    (ops/bvh.py)."""
    o = to_numpy(o).astype(np.float32).reshape(3)
    d = to_numpy(d).astype(np.float32).reshape(3)
    meta = bvh.node_meta
    vis, dead = [], []
    best_t = np.float32(np.inf)
    best_perm = -1
    verts = to_numpy(scene.vertices)
    tris = to_numpy(scene.tris)
    sph_c = to_numpy(scene.sph_center)
    sph_r = to_numpy(scene.sph_radius)
    stack = [bvh.root]
    while stack:
        node = stack.pop()
        if meta[node, 0]:                            # leaf (cpp:319-327)
            for p in range(meta[node, 2], meta[node, 3]):
                if bvh.perm_is_sphere[p]:
                    c = sph_c[bvh.perm_index[p]]
                    r = float(sph_r[bvh.perm_index[p]])
                    oc = o - c
                    b = 2.0 * float(d @ oc)
                    cc = float(oc @ oc) - r * r
                    disc = b * b - 4.0 * cc
                    if disc < 0:
                        continue
                    sq = np.sqrt(disc)
                    t0, t1 = (-b - sq) / 2.0, (-b + sq) / 2.0
                    t = t0 if t0 >= 0 else t1
                    if t >= 0 and t < best_t:        # strict (spheres)
                        best_t, best_perm = np.float32(t), p
                else:
                    v0, v1, v2 = verts[tris[bvh.perm_index[p]]]
                    n = np.cross(v1 - v0, v2 - v0)
                    nn = np.linalg.norm(n)
                    if nn == 0:
                        continue
                    n = n / nn
                    denom = float(n @ d)
                    t = (float(n @ v0) - float(n @ o)) / denom \
                        if denom != 0 else np.inf
                    if not np.isfinite(t) or t < 0 or t > best_t:
                        continue
                    pt = o + t * d
                    if (np.dot(np.cross(v1 - v0, pt - v0), n) >= 0
                            and np.dot(np.cross(v2 - v1, pt - v1), n) >= 0
                            and np.dot(np.cross(v0 - v2, pt - v2), n) >= 0):
                        best_t, best_perm = np.float32(t), p  # last wins
            continue
        left, right = int(meta[node, 4]), int(meta[node, 5])
        lhit = _aabb_hit_host(o, d, bvh.node_lo[left], bvh.node_hi[left])
        rhit = _aabb_hit_host(o, d, bvh.node_lo[right], bvh.node_hi[right])
        if lhit:                                     # grey (cpp:338-342)
            vis.append((bvh.node_lo[left], bvh.node_hi[left],
                        meta[left, 1]))
        if rhit:                                     # grey (cpp:346-350)
            vis.append((bvh.node_lo[right], bvh.node_hi[right],
                        meta[right, 1]))
        if lhit:
            stack.append(left)                       # left, then right:
        if rhit:
            stack.append(right)                      # right pops first
        if not lhit and not rhit:                    # red (cpp:355-359)
            dead.append((bvh.node_lo[node], bvh.node_hi[node],
                         meta[node, 1]))

    tri = None
    if best_perm >= 0 and not bvh.perm_is_sphere[best_perm]:
        tri = verts[tris[bvh.perm_index[best_perm]]].astype(np.float32)

    def pack(items):
        if not items:
            z = np.zeros((0, 3), np.float32)
            return z, z, np.zeros(0, np.int32)
        return (np.asarray([i[0] for i in items], np.float32),
                np.asarray([i[1] for i in items], np.float32),
                np.asarray([i[2] for i in items], np.int32))

    vlo, vhi, vd = pack(vis)
    dlo, dhi, dd = pack(dead)
    return TraversalDebug(visited_lo=vlo, visited_hi=vhi, visited_depth=vd,
                          dead_lo=dlo, dead_hi=dhi, dead_depth=dd, tri=tri)


def normal_segments(scene, tri_idx, length=0.2):
    """The vertex normals of one triangle as segments (the normal debugger,
    bounding_volume_hierarchy.cpp:388-392): (starts [3, 3], ends [3, 3])."""
    tri = to_numpy(scene.tris)[tri_idx]
    v = to_numpy(scene.vertices)[tri]
    n = to_numpy(scene.normals)[tri]
    return v, v + length * n


# the 12 edges of a box over its corners, corner i = (x, y, z) bits of i
_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
          (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def aabb_segments(lo, hi):
    """Wireframe segments of boxes (drawAABB, draw.cpp:184-197). lo, hi:
    [B, 3]. Returns (a [B * 12, 3], b [B * 12, 3])."""
    lo = np.atleast_2d(to_numpy(lo))
    hi = np.atleast_2d(to_numpy(hi))
    B = lo.shape[0]
    corners = np.stack([np.where([(i >> a) & 1 for a in range(3)], hi[b],
                                 lo[b])
                        for b in range(B) for i in range(8)])
    corners = corners.reshape(B, 8, 3)
    a = corners[:, [e[0] for e in _EDGES]]
    b = corners[:, [e[1] for e in _EDGES]]
    return a.reshape(-1, 3), b.reshape(-1, 3)


def _camera_space(camera: Camera, points):
    """World to camera space: the inverse of the trackball's rotation."""
    p = np.atleast_2d(to_numpy(points).astype(np.float32))
    w, x, y, z = quat_from_euler(
        torch.tensor(camera.rotation, dtype=torch.float32)).numpy()
    # rotation by the conjugate (world -> camera)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
        [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
        [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return (p - camera.position("cpu").numpy()) @ R.T


def project_points(camera: Camera, points, width: int, height: int):
    """World to pixel coordinates: the inverse of Trackball::generateRay
    (trackball.cpp:101-110), its negated x included. Returns (px [N, 2]
    float, row 0 the top; in_front [N] bool)."""
    cam = _camera_space(camera, points)
    zc = cam[:, 2]
    in_front = zc > 1e-6
    zs = np.where(in_front, zc, 1.0)
    ndc_x = -cam[:, 0] / (zs * camera.half_screen_w)
    ndc_y = cam[:, 1] / (zs * camera.half_screen_h)
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - (ndc_y + 1.0) * 0.5) * height
    return np.stack([px, py], axis=-1), in_front


def draw_segments(image, camera: Camera, a, b, color=(0.0, 1.0, 0.0),
                  samples_per_seg: int | None = None):
    """A copy of image ([H, W, 3], row 0 the top) with the 3-D segments
    a -> b drawn in: each segment clipped to the camera's near plane,
    point-sampled (8 x the image's larger side by default, so a debug
    ray's 100-unit miss segment leaves no gaps) and splatted."""
    img = np.array(image, np.float32, copy=True)
    h, w = img.shape[:2]
    if samples_per_seg is None:
        samples_per_seg = 8 * max(w, h)
    a0 = np.atleast_2d(to_numpy(a).astype(np.float32))
    b0 = np.atleast_2d(to_numpy(b).astype(np.float32))
    eps = 1e-4
    za = _camera_space(camera, a0)[:, 2]
    zb = _camera_space(camera, b0)[:, 2]
    ok = np.maximum(za, zb) > eps
    dz = np.where(zb == za, 1.0, zb - za)
    ta = np.clip((eps - za) / dz, 0.0, 1.0)
    tb = np.clip((eps - zb) / -dz, 0.0, 1.0)
    a = np.where((za < eps)[:, None], a0 + ta[:, None] * (b0 - a0), a0)
    b = np.where((zb < eps)[:, None], b0 + tb[:, None] * (a0 - b0), b0)
    pa, _ = project_points(camera, a, w, h)
    pb, _ = project_points(camera, b, w, h)
    ts = np.linspace(0.0, 1.0, samples_per_seg, dtype=np.float32)
    pts = (pa[ok, None, :] * (1 - ts[None, :, None])
           + pb[ok, None, :] * ts[None, :, None]).reshape(-1, 2)
    xi = np.round(pts[:, 0]).astype(int)
    yi = np.round(pts[:, 1]).astype(int)
    keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[keep], xi[keep]] = np.asarray(color, np.float32)
    return img
