"""Wavefront OBJ/MTL loader (counterpart of cge_tpu/scene/mesh_io.py:117-325).

Same semantics as the JAX package's loader (tinyobjloader followed by the
reference's loadMesh, framework/src/mesh.cpp:52-149):

  - shapes split on `o`/`g`; quads split along the shortest diagonal
    (tiny_obj_loader.h:1428-1536), n-gons fanned;
  - each shape split into sub-meshes by runs of material id, with the
    loop's quirk that a last triangle of another material joins the
    previous run (mesh.cpp:76-142);
  - per-submesh vertex dedup on exact (position, normal, texcoord);
  - geometric-normal fallback for corners without a normal index;
  - material defaults and the material-id -1 fallback (mesh.cpp:124-127);
  - optional centerAndScaleToUnitMesh (mesh.cpp:151-176).

The statements are sorted in one pass over the lines; the numbers of the
`v`/`vt`/`vn`/`f` lines are then parsed in bulk with numpy, and
triangulation, run splitting and dedup are vectorised, so a 614k-triangle
file loads in seconds instead of minutes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Image:
    """framework/include/framework/image.h:11-18."""

    width: int
    height: int
    pixels: np.ndarray  # [H, W, 3] f32 in [0, 1], row 0 = top


def load_image(path: str) -> Image:
    """stb_image-style load: forced RGB, u8 -> f32 / 255."""
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8).astype(np.float32) / 255.0
    h, w = arr.shape[:2]
    return Image(width=w, height=h, pixels=arr)


@dataclasses.dataclass
class Material:
    """framework/include/framework/mesh.h:22-34."""

    kd: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    ks: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    shininess: float = 1.0
    transparency: float = 1.0
    kd_texture: Optional[Image] = None


@dataclasses.dataclass
class SubMesh:
    """framework/include/framework/mesh.h:36-43."""

    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray    # [V, 3] f32
    texcoords: np.ndarray  # [V, 2] f32
    triangles: np.ndarray  # [T, 3] u32
    material: Material


def _parse_mtl(path: str) -> dict:
    """Parse a .mtl file into name -> dict (tinyobj's field subset)."""
    materials: dict = {}
    cur = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = {"kd": np.zeros(3, np.float32),
                       "ks": np.zeros(3, np.float32),
                       "shininess": 1.0, "dissolve": 1.0, "map_kd": None}
                materials[line[len("newmtl"):].strip()] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur["kd"] = np.array([float(p) for p in parts[1:4]], np.float32)
            elif key == "Ks" and len(parts) >= 4:
                cur["ks"] = np.array([float(p) for p in parts[1:4]], np.float32)
            elif key == "Ns" and len(parts) >= 2:
                cur["shininess"] = float(parts[1])
            elif key == "d" and len(parts) >= 2:
                cur["dissolve"] = float(parts[1])
            elif key == "Tr" and len(parts) >= 2:
                cur["dissolve"] = 1.0 - float(parts[1])
            elif key == "map_Kd":
                cur["map_kd"] = line[len("map_Kd"):].strip()
    return materials


def _floats(lines: list, width: int) -> np.ndarray:
    """The first `width` numbers of each line, as [N, width] float64."""
    if not lines:
        return np.zeros((0, width), np.float64)
    flat = np.fromstring(" ".join(lines), dtype=np.float64, sep=" ")
    if flat.size == width * len(lines):
        return flat.reshape(-1, width)
    # some lines carry extra numbers (v x y z w, vertex colours): per line
    return np.array([[float(p) for p in ln.split()[:width]] for ln in lines],
                    np.float64)


def _face_corners(bodies: list):
    """Face bodies -> (corners [K, 3] int64 raw OBJ indices, 0 = absent;
    corners per face [F])."""
    counts = np.array([len(b.split()) for b in bodies], np.int64)
    tokens = " ".join(bodies).split()
    first = tokens[0]
    n_slash = first.count("/")
    double = "//" in first
    joined = " ".join(tokens)
    uniform = (joined.count("/") == n_slash * len(tokens)
               and joined.count("//") == (len(tokens) if double else 0))
    if uniform:
        flat = np.fromstring(joined.replace("//", " ").replace("/", " "),
                             dtype=np.int64, sep=" ")
        fields = flat.reshape(len(tokens), -1)
        out = np.zeros((len(tokens), 3), np.int64)
        cols = {0: (0,), 1: (0, 1), 2: (0, 1, 2)}[n_slash]
        if double:
            cols = (0, 2)
        for k, c in enumerate(cols):
            out[:, c] = fields[:, k]
        return out, counts
    out = np.zeros((len(tokens), 3), np.int64)
    for i, tok in enumerate(tokens):
        for k, s in enumerate(tok.split("/")[:3]):
            out[i, k] = int(s) if s else 0
    return out, counts


def _resolve(idx: np.ndarray, n_before: np.ndarray) -> np.ndarray:
    """OBJ 1-based / negative-relative indices -> 0-based, -1 = absent."""
    return np.where(idx > 0, idx - 1, np.where(idx < 0, n_before + idx, -1))


def _triangulate(corners, counts, pos64):
    """Faces -> triangles as corner rows [T, 3] plus each triangle's face."""
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ntri = counts - 2
    face = np.repeat(np.arange(len(counts)), ntri)
    j = np.arange(len(face)) - np.repeat(np.cumsum(ntri) - ntri, ntri)
    s = starts[face]
    tri = np.stack([s, s + j + 1, s + j + 2], axis=1)     # fan
    quad = counts[face] == 4
    if quad.any():
        qs = s[quad]
        p = [pos64[corners[qs + k, 0]] for k in range(4)]
        sqr02 = np.sum((p[2] - p[0]) ** 2, axis=1)
        sqr13 = np.sum((p[3] - p[1]) ** 2, axis=1)
        pick = _QUAD_SPLIT[(sqr02 < sqr13).astype(np.int64),
                           (j[quad] == 0).astype(np.int64)]
        tri[quad] = qs[:, None] + pick
    return tri, face


# [diagonal 0-2 is shorter, first triangle of the quad] -> quad corners
_QUAD_SPLIT = np.array([[[1, 2, 3], [0, 1, 3]],
                        [[0, 2, 3], [0, 1, 2]]], np.int64)


def _runs(mat: np.ndarray):
    """The [start, end) sub-mesh ranges of mesh.cpp:76-142's loop."""
    n = len(mat)
    # next_diff[i]: first j >= i whose material differs from mat[i]
    change = np.flatnonzero(np.diff(mat)) + 1
    ends = np.append(change, n)
    next_diff = np.repeat(ends, np.diff(np.concatenate([[0], ends])))
    out = []
    start, prev, end = 0, mat[0], 0
    while end < n:
        if end == n - 1:
            end += 1
        elif mat[end] == prev:
            end = min(int(next_diff[end]), n - 1)
            continue
        else:
            prev = mat[end]
        out.append((start, end))
        start = end
        end += 1
    return out


def _dedup(pos, nrm, uv):
    """Exact (position, normal, texcoord) dedup in first-occurrence order.
    -0.0 and 0.0 are one key, as the reference's float comparison has it."""
    key = np.ascontiguousarray(
        np.concatenate([pos, nrm, uv], axis=1).astype(np.float32) + 0.0)
    view = key.view(np.dtype((np.void, key.dtype.itemsize * key.shape[1])))
    _, first, inverse = np.unique(view.ravel(), return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    keep = first[order]
    return keep, rank[inverse.ravel()]


def load_mesh(path: str, center_and_normalize: bool = False) -> list[SubMesh]:
    """loadMesh (mesh.cpp:52-149)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"File {path} does not exist.")
    base_dir = os.path.dirname(os.path.abspath(path))

    v_l, vt_l, vn_l, f_l = [], [], [], []
    f_nv, f_nvt, f_nvn = [], [], []
    mat_events, shape_events = [], []      # (first face index, value)
    material_list, material_index = [], {}
    with open(path, "r", errors="replace") as fh:
        text = fh.read()
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] == "#":
            continue
        head, c1 = line[0], line[1:2]
        if head == "v" and c1 in (" ", "\t"):
            v_l.append(line[2:])
        elif head == "v" and c1 == "t" and line[2:3] in (" ", "\t"):
            vt_l.append(line[3:])
        elif head == "v" and c1 == "n" and line[2:3] in (" ", "\t"):
            vn_l.append(line[3:])
        elif head == "f" and c1 in (" ", "\t"):
            f_l.append(line[2:])
            f_nv.append(len(v_l))
            f_nvt.append(len(vt_l))
            f_nvn.append(len(vn_l))
        else:
            parts = line.split()
            key = parts[0]
            if key in ("o", "g"):
                shape_events.append(len(f_l))
            elif key == "usemtl":
                name = line[len("usemtl"):].strip()
                mat_events.append((len(f_l), material_index.get(name, -1)))
            elif key == "mtllib":
                parsed = _parse_mtl(os.path.join(
                    base_dir, line[len("mtllib"):].strip()))
                for name, mat in parsed.items():
                    if name not in material_index:
                        material_index[name] = len(material_list)
                        material_list.append(mat)

    pos64 = _floats(v_l, 3)
    verts = pos64.astype(np.float32)
    norms = _floats(vn_l, 3).astype(np.float32)
    uvs = _floats(vt_l, 2).astype(np.float32)
    if not f_l:
        return []

    raw_c, counts = _face_corners(f_l)
    fidx = np.repeat(np.arange(len(f_l)), counts)
    corners = np.stack([
        _resolve(raw_c[:, 0], np.asarray(f_nv)[fidx]),
        _resolve(raw_c[:, 1], np.asarray(f_nvt)[fidx]),
        _resolve(raw_c[:, 2], np.asarray(f_nvn)[fidx])], axis=1)
    tri, tri_face = _triangulate(corners, counts, pos64)

    # per-face material and shape from the statement events
    faces = np.arange(len(f_l))
    ev_at = np.asarray([at for at, _ in mat_events], np.int64)
    ev_mat = np.asarray([-1] + [mid for _, mid in mat_events], np.int64)
    face_mat = ev_mat[np.searchsorted(ev_at, faces, side="right")]
    shape_of_face = np.searchsorted(np.asarray(shape_events, np.int64),
                                    faces, side="right")
    tri_mat = face_mat[tri_face]
    tri_shape = shape_of_face[tri_face]

    out: list[SubMesh] = []
    texture_cache: dict = {}
    shape_bounds = np.flatnonzero(np.diff(tri_shape)) + 1
    for lo, hi in zip(np.concatenate([[0], shape_bounds]),
                      np.append(shape_bounds, len(tri))):
        for start, end in _runs(tri_mat[lo:hi]):
            rows = tri[lo + start: lo + end].reshape(-1)          # corners
            c = corners[rows]
            pos = verts[c[:, 0]]
            p = pos.reshape(-1, 3, 3)
            gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            gl = np.sqrt(np.sum(gn * gn, axis=1, keepdims=True))
            gn = np.where(gl > 0, gn / np.where(gl > 0, gl, 1), gn)
            gn = np.repeat(gn.astype(np.float32), 3, axis=0)
            nrm = (norms[np.maximum(c[:, 2], 0)] if len(norms)
                   else np.zeros_like(gn))
            nrm = np.where((c[:, 2:3] != -1) & (len(norms) > 0), nrm, gn)
            uv = (uvs[np.maximum(c[:, 1], 0)] if len(uvs)
                  else np.zeros((len(c), 2), np.float32))
            uv = np.where((c[:, 1:2] != -1) & (len(uvs) > 0), uv, 0.0)
            keep, remap = _dedup(pos, nrm, uv)

            mat_id = int(tri_mat[lo + start])
            if mat_id == -1:
                material = Material()
            else:
                m = material_list[mat_id]
                tex = None
                if m["map_kd"]:
                    tex_path = os.path.join(base_dir, m["map_kd"])
                    if tex_path not in texture_cache:
                        texture_cache[tex_path] = load_image(tex_path)
                    tex = texture_cache[tex_path]
                material = Material(kd=m["kd"].copy(), ks=m["ks"].copy(),
                                    shininess=float(m["shininess"]),
                                    transparency=float(m["dissolve"]),
                                    kd_texture=tex)
            out.append(SubMesh(
                positions=pos[keep].astype(np.float32),
                normals=nrm[keep].astype(np.float32),
                texcoords=uv[keep].astype(np.float32),
                triangles=remap.reshape(-1, 3).astype(np.uint32),
                material=material))

    if center_and_normalize:
        center_and_scale_to_unit(out)
    return out


def center_and_scale_to_unit(meshes: list[SubMesh]) -> None:
    """centerAndScaleToUnitMesh (mesh.cpp:151-176): translate to the mean of
    all (dedup'd) vertex positions, scale by the max distance to it."""
    all_pos = np.concatenate([m.positions for m in meshes], axis=0)
    center = (all_pos.astype(np.float32).sum(axis=0)
              / np.float32(len(all_pos))).astype(np.float32)
    max_d = np.float32(np.max(np.linalg.norm(all_pos - center, axis=1)))
    for m in meshes:
        m.positions = ((m.positions - center) / max_d).astype(np.float32)
