"""The rasterized preview frame (counterpart of cge_tpu/raster/preview.py).

The reference's Rasterization view (src/main.cpp:380-464): the lit scene
meshes under GL point lights (drawSceneOpenGL, 608-658), its spheres as
tessellated quadrics (draw.cpp:79-97), and unlit light markers
(drawLightsOpenGL, 555-605: a 0.01-radius sphere per point light, endpoint
spheres and a coloured line per segment light, a Gouraud quad per
parallelogram light, a blue 0.01 sphere at the look-at point) on black
(main.cpp:373). Everything is gathered on the host into one soup of
vertices, triangles and vertex colours and rasterized in one z-buffered
pass on the scene's device.
"""

from __future__ import annotations

import numpy as np
import torch

from cge_tpu_torch.ops.bvh import to_numpy
from cge_tpu_torch.raster.lighting import gl_point_lights, gl_vertex_colors
from cge_tpu_torch.raster.matrices import camera_matrices, project_vertices
from cge_tpu_torch.raster.rasterize import rasterize, shade_gouraud



def icosphere(subdiv: int = 2):
    """The unit icosphere (host-side, cached): verts [V, 3], tris [T, 3]."""
    if subdiv in _ICO_CACHE:
        return _ICO_CACHE[subdiv]
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)
        new_faces = []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m.astype(np.float32))
            return cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        verts = np.asarray(vlist, np.float32)
        faces = np.asarray(new_faces, np.int32)
    _ICO_CACHE[subdiv] = (verts, faces)
    return verts, faces


_ICO_CACHE: dict = {}


class _Soup:
    """Host-side geometry accumulator: world verts, tris, vertex colors."""

    def __init__(self):
        self.verts, self.tris, self.colors = [], [], []
        self._off = 0

    def add(self, verts, tris, colors):
        self.verts.append(np.asarray(verts, np.float32))
        self.tris.append(np.asarray(tris, np.int32) + self._off)
        self.colors.append(np.asarray(colors, np.float32))
        self._off += len(verts)

    def arrays(self):
        return (np.concatenate(self.verts), np.concatenate(self.tris),
                np.concatenate(self.colors))


def _add_marker_sphere(soup, center, radius, color):
    v, f = icosphere(1)
    soup.add(v * radius + np.asarray(center, np.float32), f,
             np.broadcast_to(np.asarray(color, np.float32), (len(v), 3)))


def _add_line(soup, p0, p1, c0, c1, eye, px_world):
    """A GL line as a thin camera-facing quad (~1 px wide)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    seg = p1 - p0
    view = 0.5 * (p0 + p1) - np.asarray(eye, np.float32)
    side = np.cross(seg, view)
    nrm = np.linalg.norm(side)
    if nrm < 1e-12:
        return
    side = side / nrm * (0.5 * px_world)
    soup.add(np.stack([p0 - side, p0 + side, p1 + side, p1 - side]),
             np.array([[0, 1, 2], [0, 2, 3]], np.int32),
             np.stack([c0, c0, c1, c1]).astype(np.float32))


def preview_soup(scene, camera, height: int, show_lights: bool = True,
                 sphere_subdiv: int = 3):
    """The preview's geometry on the host: (vertices [V, 3] f32, triangles
    [T, 3] i32 in draw order, vertex colours [V, 3] f32)."""
    soup = _Soup()
    tri_mask = to_numpy(scene.tri_mask)
    soup.add(to_numpy(scene.vertices), to_numpy(scene.tris)[tri_mask],
             to_numpy(gl_vertex_colors(scene)))

    # the spheres, tessellated like gluSphere (draw.cpp:79-97), with the
    # GL diffuse term at each vertex and the sphere's kd
    lpos, lcol, lmask = (to_numpy(x) for x in gl_point_lights(scene))
    lcol = np.clip(lcol, 0.0, 1.0)
    iv, it = icosphere(sphere_subdiv)
    sph_c, sph_r = to_numpy(scene.sph_center), to_numpy(scene.sph_radius)
    kd_all, sph_mat = to_numpy(scene.mat_kd), to_numpy(scene.sph_mat)
    for si in np.nonzero(to_numpy(scene.sph_mask))[0]:
        kd = kd_all[int(sph_mat[si])]
        verts = iv * float(sph_r[si]) + sph_c[si]
        ldir = lpos[None] - verts[:, None]
        ldir /= np.maximum(np.linalg.norm(ldir, axis=-1, keepdims=True),
                           1e-20)
        ndl = np.maximum((iv[:, None] * ldir).sum(-1), 0.0)
        col = (ndl[..., None] * lcol[None] * lmask[None, :, None]).sum(1)
        soup.add(verts, it, np.clip(kd[None] * col, 0.0, 1.0))

    eye = camera.position("cpu").numpy()
    if show_lights:
        # unlit light markers (drawLightsOpenGL, main.cpp:555-605)
        look = np.asarray(camera.look_at, np.float32)
        dist = float(np.linalg.norm(eye - look)) + 1e-6
        px_world = dist * 2.0 * float(np.tan(camera.fovy / 2.0)) / height
        pp, pc = to_numpy(scene.point_pos), to_numpy(scene.point_color)
        for i in np.nonzero(to_numpy(scene.point_mask))[0]:
            _add_marker_sphere(soup, pp[i], 0.01, pc[i])
        s0, s1 = to_numpy(scene.seg_p0), to_numpy(scene.seg_p1)
        c0, c1 = to_numpy(scene.seg_c0), to_numpy(scene.seg_c1)
        for i in np.nonzero(to_numpy(scene.seg_mask))[0]:
            _add_line(soup, s0[i], s1[i], c0[i], c1[i], eye, px_world)
            _add_marker_sphere(soup, s0[i], 0.01, c0[i])
            _add_marker_sphere(soup, s1[i], 0.01, c1[i])
        q = {k: to_numpy(getattr(scene, k)) for k in (
            "par_v0", "par_e01", "par_e02", "par_c0", "par_c1", "par_c2",
            "par_c3")}
        for i in np.nonzero(to_numpy(scene.par_mask))[0]:
            v0, e01, e02 = q["par_v0"][i], q["par_e01"][i], q["par_e02"][i]
            # GL_QUADS order v0, v0 + e01, v0 + e01 + e02, v0 + e02 with
            # colours c0, c1, c3, c2 (main.cpp:600-612)
            quad = np.stack([v0, v0 + e01, v0 + e01 + e02, v0 + e02])
            cs = [q["par_c0"][i], q["par_c1"][i], q["par_c3"][i],
                  q["par_c2"][i]]
            soup.add(quad, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     np.stack(cs).astype(np.float32))
        _add_marker_sphere(soup, look, 0.01, (0.2, 0.2, 1.0))  # :603-605
    return soup.arrays()


@torch.no_grad()
def render_preview(scene, camera, width: int, height: int,
                   show_lights: bool = True, sphere_subdiv: int = 3):
    """The rasterized preview [H, W, 3] f32 on the scene's device, row 0
    the top of the image (flipped from GL window coordinates as
    Screen::setPixel flips, screen.cpp:41-47)."""
    dev = scene.device
    verts, tris_all, colors = (
        torch.from_numpy(a).to(dev)
        for a in preview_soup(scene, camera, height, show_lights,
                              sphere_subdiv))
    view, proj = camera_matrices(camera, width, height, dev)
    xy, z, w = project_vertices(verts, view, proj, width, height)
    tri_id, _ = rasterize(xy, z, w, tris_all, width, height)
    img = shade_gouraud(tri_id, xy, z, tris_all, colors)
    return torch.flip(img, dims=(0,))
