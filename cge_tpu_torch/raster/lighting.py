"""Fixed-function GL vertex lighting for the preview (counterpart of
cge_tpu/raster/lighting.py).

What drawSceneOpenGL sets up (src/main.cpp:608-658) with setMaterial
(src/draw.cpp:27-36): every scene light becomes legacy point lights (a
point light itself, a segment light its two endpoints at half colour, a
parallelogram light its four corners at quarter colour); ambient and
specular are zero, so a vertex's colour is
    sum_l kd * clamp(light colour, 0, 1) * max(dot(n, l), 0)
with constant attenuation 1 and renormalised normals (GL_NORMALIZE),
clamped to [0, 1] and Gouraud-interpolated by the rasterizer.
"""

from __future__ import annotations

import torch

from cge_tpu_torch.ops import fp32


def gl_point_lights(scene):
    """The scene's lights as legacy point lights: (positions [K, 3],
    colours [K, 3], mask [K]) over every slot of each kind."""
    v0, e01, e02 = scene.par_v0, scene.par_e01, scene.par_e02
    pos = [scene.point_pos, scene.seg_p0, scene.seg_p1,
           v0, v0 + e01, v0 + e02, v0 + e01 + e02]
    col = [scene.point_color, 0.5 * scene.seg_c0, 0.5 * scene.seg_c1,
           0.25 * scene.par_c0, 0.25 * scene.par_c1,
           0.25 * scene.par_c2, 0.25 * scene.par_c3]
    msk = [scene.point_mask] + [scene.seg_mask] * 2 + [scene.par_mask] * 4
    return torch.cat(pos), torch.cat(col), torch.cat(msk)


def vertex_materials(scene):
    """Each vertex's kd through its triangle's material (meshes are split
    per material and their vertices deduplicated per mesh, framework/src/
    mesh.cpp:79-119, so a vertex has one material). Padding triangles
    write into a sentinel row past the vertices."""
    V = scene.vertices.shape[0]
    vert_mat = torch.zeros(V + 1, dtype=torch.int64,
                           device=scene.vertices.device)
    valid = scene.tri_mask
    tm = torch.where(valid, scene.tri_mat, 0)
    for k in range(3):
        idx = torch.where(valid, scene.tris[:, k], V)
        vert_mat[idx] = tm
    return scene.mat_kd[vert_mat[:V]]


def _unit(v):
    return v / fp32.sqrt_rn(fp32.dot3(v, v)).clamp_min(1e-20)[..., None]


def gl_vertex_colors(scene):
    """Per-vertex GL-lit colours [V, 3] (the diffuse term only)."""
    n = _unit(scene.normals)
    kd = vertex_materials(scene)
    lpos, lcol, lmask = gl_point_lights(scene)
    lcol = lcol.clamp(0.0, 1.0)
    ldir = _unit(lpos[None, :, :] - scene.vertices[:, None, :])   # [V, K, 3]
    ndotl = fp32.dot3(n[:, None, :], ldir).clamp_min(0.0)
    contrib = ndotl[..., None] * lcol[None, :, :]
    contrib = torch.where(lmask[None, :, None], contrib, 0.0)
    total = contrib[:, 0]
    for k in range(1, contrib.shape[1]):          # summed in slot order
        total = total + contrib[:, k]
    return (kd * total).clamp(0.0, 1.0)
