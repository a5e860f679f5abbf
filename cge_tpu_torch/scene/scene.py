"""Scene data model (counterpart of cge_tpu/scene/scene.py:117-438).

`SceneArrays` holds the flattened, padded and masked scene as torch tensors
on one device, named as in the JAX package. Beside the tensors it keeps
host copies of what the trace branches on (the light-slot masks,
`all_opaque`, `all_diffuse`), so skipping a dead light slot needs no device
sync.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Sequence, Union

import numpy as np
import torch

from cge_tpu_torch.ops.bvh import build_clusters
from cge_tpu_torch.scene.mesh_io import Material, SubMesh, load_mesh


class SceneType(enum.IntEnum):
    """src/scene.h:15-26."""

    SingleTriangle = 0
    Cube = 1
    CubeTextured = 2
    CornellBox = 3
    CornellBoxParallelogramLight = 4
    Monkey = 5
    Teapot = 6
    Dragon = 7
    Spheres = 8
    Custom = 9


@dataclasses.dataclass
class PointLight:
    position: Sequence[float]
    color: Sequence[float]


@dataclasses.dataclass
class SegmentLight:
    endpoint0: Sequence[float]
    endpoint1: Sequence[float]
    color0: Sequence[float]
    color1: Sequence[float]


@dataclasses.dataclass
class ParallelogramLight:
    v0: Sequence[float]
    edge01: Sequence[float]
    edge02: Sequence[float]
    color0: Sequence[float]
    color1: Sequence[float]
    color2: Sequence[float]
    color3: Sequence[float]


@dataclasses.dataclass
class SphereDef:
    center: Sequence[float]
    radius: float
    material: Material


Light = Union[PointLight, SegmentLight, ParallelogramLight]

# the tensor fields of SceneArrays, in the JAX package's order
TENSOR_FIELDS = (
    "vertices", "normals", "uvs", "tris", "tri_mat", "tri_mask",
    "mat_kd", "mat_ks", "mat_shininess", "mat_transparency", "mat_tex",
    "textures", "tex_hw",
    "sph_center", "sph_radius", "sph_mat", "sph_mask",
    "point_pos", "point_color", "point_mask",
    "seg_p0", "seg_p1", "seg_c0", "seg_c1", "seg_mask",
    "par_v0", "par_e01", "par_e02", "par_c0", "par_c1", "par_c2", "par_c3",
    "par_mask", "cluster_perm")


@dataclasses.dataclass
class SceneArrays:
    """Flattened scene; every tensor lies on `device`. Triangle t's corners
    are vertices[tris[t]], its material row tri_mat[t]; sphere materials
    follow the mesh materials in the same table."""

    vertices: torch.Tensor      # [V, 3] f32
    normals: torch.Tensor       # [V, 3] f32
    uvs: torch.Tensor           # [V, 2] f32
    tris: torch.Tensor          # [T, 3] i64
    tri_mat: torch.Tensor       # [T] i64
    tri_mask: torch.Tensor      # [T] bool
    mat_kd: torch.Tensor        # [M, 3] f32
    mat_ks: torch.Tensor        # [M, 3] f32
    mat_shininess: torch.Tensor  # [M] f32
    mat_transparency: torch.Tensor  # [M] f32
    mat_tex: torch.Tensor       # [M] i64, -1 = none
    textures: torch.Tensor      # [K, TH, TW, 3] f32
    tex_hw: torch.Tensor        # [K, 2] i64
    sph_center: torch.Tensor    # [S, 3] f32
    sph_radius: torch.Tensor    # [S] f32
    sph_mat: torch.Tensor       # [S] i64
    sph_mask: torch.Tensor      # [S] bool
    point_pos: torch.Tensor     # [LP, 3]
    point_color: torch.Tensor   # [LP, 3]
    point_mask: torch.Tensor    # [LP] bool
    seg_p0: torch.Tensor        # [LS, 3]
    seg_p1: torch.Tensor
    seg_c0: torch.Tensor
    seg_c1: torch.Tensor
    seg_mask: torch.Tensor      # [LS] bool
    par_v0: torch.Tensor        # [LQ, 3]
    par_e01: torch.Tensor
    par_e02: torch.Tensor
    par_c0: torch.Tensor
    par_c1: torch.Tensor
    par_c2: torch.Tensor
    par_c3: torch.Tensor
    par_mask: torch.Tensor      # [LQ] bool
    cluster_perm: torch.Tensor  # [L, C] i64 triangle ids, -1 = pad
    # host copies: what the trace branches on without a device sync
    point_mask_host: tuple = ()
    seg_mask_host: tuple = ()
    par_mask_host: tuple = ()
    all_opaque: bool = True
    all_diffuse: bool = False

    @property
    def device(self) -> torch.device:
        return self.vertices.device


def scene_from_numpy(arrays: dict, *, all_opaque: bool, all_diffuse: bool,
                    device) -> SceneArrays:
    """Numpy leaves (JAX package names) -> SceneArrays on `device`."""
    missing = [k for k in TENSOR_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"scene leaves missing: {missing}")
    tensors = {}
    for k in TENSOR_FIELDS:
        a = np.asarray(arrays[k])
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.float32))
        tensors[k] = t.to(device)
    host = {f"{k}_host": tuple(bool(x) for x in np.asarray(arrays[k]))
            for k in ("point_mask", "seg_mask", "par_mask")}
    return SceneArrays(**tensors, **host, all_opaque=bool(all_opaque),
                       all_diffuse=bool(all_diffuse))


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: `device`, the card by default.
    A CUDA device without a card raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: pass device='cpu' to "
                           f"build on the CPU")
    return dev


def _f(x):
    return np.asarray(x, np.float32)


def build_scene_arrays(meshes: Sequence[SubMesh],
                       spheres: Sequence[SphereDef] = (),
                       lights: Sequence[Light] = (),
                       pad_tris_to: int = 8,
                       device=None) -> SceneArrays:
    """Flatten host-side meshes/spheres/lights into SceneArrays on
    `device` (resolve_device: the card by default)."""
    device = resolve_device(device)
    positions, normals, uvs, tris, tri_mat = [], [], [], [], []
    mat_kd, mat_ks, mat_sh, mat_tr, mat_tex = [], [], [], [], []
    textures: list = []
    tex_hw: list = []
    voff = 0
    for m in meshes:
        positions.append(m.positions)
        normals.append(m.normals)
        uvs.append(m.texcoords)
        tris.append(m.triangles.astype(np.int64) + voff)
        voff += len(m.positions)
        tri_mat.append(np.full(len(m.triangles), len(mat_kd), np.int64))
        mat_kd.append(_f(m.material.kd))
        mat_ks.append(_f(m.material.ks))
        mat_sh.append(np.float32(m.material.shininess))
        mat_tr.append(np.float32(m.material.transparency))
        if m.material.kd_texture is not None:
            tex = m.material.kd_texture
            mat_tex.append(len(textures))
            textures.append(tex.pixels)
            tex_hw.append((tex.height, tex.width))
        else:
            mat_tex.append(-1)
    for s in spheres:
        mat_kd.append(_f(s.material.kd))
        mat_ks.append(_f(s.material.ks))
        mat_sh.append(np.float32(s.material.shininess))
        mat_tr.append(np.float32(s.material.transparency))
        mat_tex.append(-1)

    def cat(parts, width, dtype=np.float32):
        if parts:
            return np.concatenate(
                [np.asarray(p, dtype).reshape(-1, width) for p in parts])
        return np.zeros((0, width), dtype)

    V = cat(positions, 3)
    N = cat(normals, 3)
    UV = cat(uvs, 2)
    T = cat(tris, 3, np.int64)
    TM = np.concatenate(tri_mat) if tri_mat else np.zeros(0, np.int64)

    nt = len(T)
    padded_nt = max(pad_tris_to, -(-max(nt, 1) // pad_tris_to) * pad_tris_to)
    tri_mask = np.zeros(padded_nt, bool)
    tri_mask[:nt] = True
    T = np.concatenate([T, np.zeros((padded_nt - nt, 3), np.int64)])
    TM = np.concatenate([TM, np.zeros(padded_nt - nt, np.int64)])
    if len(V) == 0:
        V = np.zeros((1, 3), np.float32)
        N = np.zeros((1, 3), np.float32)
        UV = np.zeros((1, 2), np.float32)

    M = max(1, len(mat_kd))
    kd = np.zeros((M, 3), np.float32)
    ks = np.zeros((M, 3), np.float32)
    sh = np.ones(M, np.float32)
    tr = np.ones(M, np.float32)
    tx = np.full(M, -1, np.int64)
    for i in range(len(mat_kd)):
        kd[i], ks[i], sh[i], tr[i], tx[i] = (mat_kd[i], mat_ks[i], mat_sh[i],
                                             mat_tr[i], mat_tex[i])

    if textures:
        th = max(t.shape[0] for t in textures)
        tw = max(t.shape[1] for t in textures)
        stack = np.zeros((len(textures), th, tw, 3), np.float32)
        hw = np.zeros((len(textures), 2), np.int64)
        for i, t in enumerate(textures):
            stack[i, : t.shape[0], : t.shape[1]] = t
            hw[i] = (t.shape[0], t.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        hw = np.ones((1, 2), np.int64)

    S = max(1, len(spheres))
    sc = np.zeros((S, 3), np.float32)
    sr = np.ones(S, np.float32)
    sm = np.zeros(S, np.int64)
    smask = np.zeros(S, bool)
    for i, s in enumerate(spheres):
        sc[i] = _f(s.center)
        sr[i] = np.float32(s.radius)
        sm[i] = len(mat_kd) - len(spheres) + i
        smask[i] = True

    def pack(kind, getters):
        items = [l for l in lights if isinstance(l, kind)]
        n = max(1, len(items))
        arrs = [np.zeros((n, 3), np.float32) for _ in getters]
        mask = np.zeros(n, bool)
        for i, it in enumerate(items):
            for a, g in zip(arrs, getters):
                a[i] = _f(g(it))
            mask[i] = True
        return arrs, mask

    (pp, pc), pmask = pack(PointLight, [lambda l: l.position,
                                        lambda l: l.color])
    (s0, s1, sc0, sc1), lmask = pack(
        SegmentLight, [lambda l: l.endpoint0, lambda l: l.endpoint1,
                       lambda l: l.color0, lambda l: l.color1])
    (q0, qe1, qe2, qc0, qc1, qc2, qc3), qmask = pack(
        ParallelogramLight, [lambda l: l.v0, lambda l: l.edge01,
                             lambda l: l.edge02, lambda l: l.color0,
                             lambda l: l.color1, lambda l: l.color2,
                             lambda l: l.color3])

    leaves = dict(
        vertices=V, normals=N, uvs=UV, tris=T, tri_mat=TM, tri_mask=tri_mask,
        mat_kd=kd, mat_ks=ks, mat_shininess=sh, mat_transparency=tr,
        mat_tex=tx, textures=stack, tex_hw=hw,
        sph_center=sc, sph_radius=sr, sph_mat=sm, sph_mask=smask,
        point_pos=pp, point_color=pc, point_mask=pmask,
        seg_p0=s0, seg_p1=s1, seg_c0=sc0, seg_c1=sc1, seg_mask=lmask,
        par_v0=q0, par_e01=qe1, par_e02=qe2, par_c0=qc0, par_c1=qc1,
        par_c2=qc2, par_c3=qc3, par_mask=qmask,
        cluster_perm=build_clusters(V, T, tri_mask))
    return scene_from_numpy(leaves, all_opaque=bool(np.all(tr == 1.0)),
                           all_diffuse=bool(np.all(ks == 0.0)),
                           device=device)


def load_scene_prebuilt(scene_type: SceneType, data_dir: str | None = None,
                        device=None) -> SceneArrays:
    """The hardcoded scene registry (src/scene.cpp:5-92), on `device` (the
    card by default). Spheres needs no data files; the mesh scenes load
    their OBJ from `data_dir`, the reference's data directory, and raise
    FileNotFoundError without it."""
    device = resolve_device(device)
    meshes, spheres, lights = prebuilt_scene_parts(scene_type, data_dir)
    return build_scene_arrays(meshes, spheres, lights, device=device)


def prebuilt_scene_parts(scene_type: SceneType, data_dir: str | None = None):
    """The registry's host-side parts (meshes, spheres, lights)."""
    t = SceneType(scene_type)
    if t == SceneType.Spheres:
        spheres = [
            SphereDef((3.0, -2.0, 10.2), 1.0,
                      Material(kd=_f((0.8, 0.2, 0.2)))),
            SphereDef((-2.0, 2.0, 4.0), 2.0,
                      Material(kd=_f((0.6, 0.8, 0.2)))),
            SphereDef((0.0, 0.0, 6.0), 0.75,
                      Material(kd=_f((0.2, 0.2, 0.8)))),
        ]
        return [], spheres, [PointLight((3, 0, 3), (15, 15, 15))]
    white = PointLight((-1, 1, -1), (1, 1, 1))
    registry = {
        SceneType.SingleTriangle: ("triangle.obj", False, [white]),
        SceneType.Cube: ("cube.obj", False, [SegmentLight(
            (1.5, 0.5, -0.6), (-1, 0.5, -0.5), (0.9, 0.2, 0.1),
            (0.2, 1, 0.3))]),
        SceneType.CubeTextured: ("cube-textured.obj", False,
                                 [PointLight((-1.0, 1.5, -1.0), (1, 1, 1))]),
        SceneType.CornellBox: ("CornellBox-Mirror-Rotated.obj", True,
                               [PointLight((0, 0.58, 0), (1, 1, 1))]),
        SceneType.CornellBoxParallelogramLight: (
            "CornellBox-Mirror-Rotated.obj", True, [ParallelogramLight(
                (-0.2, 0.5, 0), (0.4, 0, 0), (0, 0, 0.4), (1, 0, 0),
                (0, 1, 0), (0, 0, 1), (0, 1, 1))]),
        SceneType.Monkey: ("monkey.obj", True,
                           [white, PointLight((1, -1, -1), (1, 1, 1))]),
        SceneType.Teapot: ("teapot.obj", True, [white]),
        SceneType.Dragon: ("dragon.obj", True, [white]),
        SceneType.Custom: ("custom.obj", False, [white]),
    }
    name, normalize, lights = registry[t]
    if data_dir is None:
        raise FileNotFoundError(
            f"{t.name} loads {name}: pass data_dir, the directory of the "
            "reference's data files")
    meshes = load_mesh(os.path.join(data_dir, name), normalize)
    if t == SceneType.SingleTriangle:
        meshes[0].material.kd = np.ones(3, np.float32)   # scene.cpp:13
    return meshes, [], lights


def load_scene_from_file(path: str, lights: Sequence[Light],
                         device=None) -> SceneArrays:
    """loadSceneFromFile (src/scene.cpp:94-103), on `device` (the card by
    default)."""
    device = resolve_device(device)
    return build_scene_arrays(load_mesh(path), (), lights, device=device)

