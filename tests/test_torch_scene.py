"""The port's host side against the JAX package: the OBJ loader, the scene
arrays, the numpy interop, the camera, the scene registry, and the
package's import boundary (cge_tpu_torch never imports JAX)."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.scene import mesh_io as jmesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu_torch.camera import pixel_grid
from cge_tpu_torch.interop import (TENSOR_FIELDS, camera_from_numpy,
                                   params_from_numpy, scene_from_numpy)
from cge_tpu_torch.scene import mesh_io
from cge_tpu_torch.scene.scene import build_scene_arrays
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parent.parent / "cge_tpu_torch"
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


@pytest.fixture(scope="module")
def dragon_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "dragon_small.obj")
    write_obj(path, 41, 32)
    return path


@pytest.fixture(scope="module")
def jax_dragon(dragon_obj):
    return cge_tpu.load_scene_from_file(dragon_obj, [JPointLight(*LIGHT)])


def test_loader_matches_jax(dragon_obj, jax_dragon):
    """Every geometry, material and light leaf equals the JAX package's
    (native loader); the clusters hold the same triangles in the same
    cluster order, members possibly reordered (argpartition vs
    nth_element)."""
    mine = ct.load_scene_from_file(dragon_obj, [ct.PointLight(*LIGHT)],
                                   device="cpu")
    for k in TENSOR_FIELDS:
        got = getattr(mine, k).numpy()
        want = np.asarray(getattr(jax_dragon, k))
        assert got.shape == want.shape, k
        if k == "cluster_perm":
            assert all(set(a) == set(b) for a, b in zip(got, want))
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), k)
    assert (mine.all_opaque, mine.all_diffuse) == (jax_dragon.all_opaque,
                                                   jax_dragon.all_diffuse)
    assert mine.point_mask_host == (True,)


OBJ_VARIANTS = """\
mtllib variants.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.6 0
v 2 0 1
v 3 0.2 1
v 3 1 1.5
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 0 -1
o first
usemtl red
f 1/1/1 2/2/1 3/3/1 4/1/1
f 1//2 3//2 5//2
f -4 -3 -2 -1 5
usemtl blue
f 6/1 7/2 8/3
g second
usemtl red
f 1 2 3
f 2 3 4
f 2 3 4
usemtl blue
f 3 4 5
f 1 4 5
usemtl red
f 1 2 5
"""

MTL_VARIANTS = """\
newmtl red
Kd 0.8 0.1 0.1
Ks 0.5 0.5 0.5
Ns 10
d 1.0
newmtl blue
Kd 0.1 0.1 0.8
Tr 0.25
"""


def test_loader_statement_variants_match_python_oracle(tmp_path):
    """Quads (shortest diagonal), an n-gon fan, v//vn, v/vt, negative
    indices, faces without normals (geometric fallback), two shapes,
    material runs including a last triangle that joins the previous run,
    Tr, and center_and_scale_to_unit: submesh by submesh equal to the JAX
    package's pure-Python loader, its semantic oracle."""
    (tmp_path / "variants.mtl").write_text(MTL_VARIANTS)
    path = tmp_path / "variants.obj"
    path.write_text(OBJ_VARIANTS)
    for normalize in (False, True):
        mine = mesh_io.load_mesh(str(path), normalize)
        ref = jmesh._load_mesh_python(str(path), normalize)
        assert len(mine) == len(ref) == 3
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.triangles, b.triangles)
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.normals, b.normals)
            np.testing.assert_array_equal(a.texcoords, b.texcoords)
            np.testing.assert_array_equal(a.material.kd, b.material.kd)
            np.testing.assert_array_equal(a.material.ks, b.material.ks)
            assert a.material.shininess == b.material.shininess
            assert a.material.transparency == b.material.transparency


def test_loader_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        mesh_io.load_mesh(str(tmp_path / "absent.obj"))


def test_scene_from_numpy(jax_dragon):
    """JAX leaves as numpy -> the port's tensors: same values, integer
    leaves as int64, host copies of the light masks and scene flags."""
    leaves = {k: np.asarray(getattr(jax_dragon, k)) for k in TENSOR_FIELDS}
    s = scene_from_numpy(leaves, all_opaque=True, all_diffuse=False,
                         device="cpu")
    for k in TENSOR_FIELDS:
        t = getattr(s, k)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), leaves[k].astype(
            t.numpy().dtype))
    assert s.tris.dtype == torch.int64 and s.vertices.dtype == torch.float32
    assert s.tri_mask.dtype == torch.bool
    assert s.point_mask_host == (True,) and s.seg_mask_host == (False,)
    assert s.all_opaque and not s.all_diffuse
    del leaves["cluster_perm"]
    with pytest.raises(KeyError):
        scene_from_numpy(leaves, all_opaque=True, all_diffuse=False,
                         device="cpu")


@pytest.mark.parametrize("cam", [
    dict(),
    dict(fovy=np.radians(65.0), distance=2.2, look_at=(0.1, -0.1, 0.0),
         rotation=tuple(np.radians((-15.0, 40.0, 0.0))), aspect=1.5)])
def test_camera_matches_jax(cam):
    """Primary rays (negated-x quirk, pixel corners) equal the JAX
    package's to f32 rounding (rtol 1e-6: sin/cos/tan of two libraries)."""
    jcam = cge_tpu.Camera(**cam)
    mine = camera_from_numpy(jcam.fovy, jcam.distance, jcam.look_at,
                             jcam.rotation, jcam.aspect)
    from cge_tpu.camera import pixel_grid as jgrid
    np.testing.assert_array_equal(pixel_grid(24, 16, device="cpu").numpy(),
                                  np.asarray(jgrid(24, 16)))
    jo, jd = jcam.generate_rays(jgrid(24, 16))
    o, d = mine.generate_rays(pixel_grid(24, 16, device="cpu"))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_spheres_registry_matches_jax():
    mine = ct.load_scene_prebuilt(ct.SceneType.Spheres, device="cpu")
    ref = cge_tpu.load_scene_prebuilt(cge_tpu.SceneType.Spheres)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(
            getattr(mine, k).numpy(),
            np.asarray(getattr(ref, k)).astype(getattr(mine, k).numpy().dtype))
    assert mine.all_diffuse and mine.all_opaque


def test_registry_needs_its_data_dir(tmp_path):
    """Scenes that need reference data fail loudly where it is missing."""
    with pytest.raises(FileNotFoundError):
        ct.load_scene_prebuilt(ct.SceneType.Teapot, data_dir=str(tmp_path),
                               device="cpu")
    with pytest.raises(FileNotFoundError, match="data_dir"):
        ct.load_scene_prebuilt(ct.SceneType.CornellBox, device="cpu")


DEFAULT_DEVICE_CALLS = {
    "build_scene_arrays": lambda obj: build_scene_arrays(
        (), (), [ct.PointLight(*LIGHT)]),
    "load_scene_prebuilt": lambda obj: ct.load_scene_prebuilt(
        ct.SceneType.Spheres),
    "load_scene_from_file": lambda obj: ct.load_scene_from_file(
        obj, [ct.PointLight(*LIGHT)]),
    "params_from_numpy": lambda obj: params_from_numpy(
        {k: np.zeros((2, 3), np.float32) for k in ct.DIFF_FIELDS}),
    "pixel_grid": lambda obj: pixel_grid(4, 2),
    "camera_position": lambda obj: ct.Camera().position(),
}


@pytest.mark.parametrize("entry", list(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(dragon_obj, entry):
    """Without a device argument the entry points and the camera helpers
    build on the card; on a machine without one they raise instead of
    falling back to the CPU."""
    call = DEFAULT_DEVICE_CALLS[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(dragon_obj)
        return
    out = call(dragon_obj)
    tensors = (out.values() if isinstance(out, dict) else
               [out] if isinstance(out, torch.Tensor) else [out.vertices])
    assert all(t.device.type == "cuda" for t in tensors)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """An AST scan of every module of the port and of chip_smoke.py: no
    jax, no cge_tpu. (A sys.modules check cannot work here: the
    interpreter's startup already imports jax.)"""
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) >= 18
    names = {f.relative_to(PKG.parent).as_posix() for f in files}
    assert {"cge_tpu_torch/ops/sweep.py", "cge_tpu_torch/diff/gradients.py",
            "cge_tpu_torch/diff/__init__.py",
            "cge_tpu_torch/ops/stream_probe.py"} <= names
    tools = {f"cge_tpu_torch/tools/{m}.py" for m in (
        "__init__", "common", "sweep_grid", "dragon_grid", "mxu_grid",
        "stream_layout")}
    assert tools <= names
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "cge_tpu")]
    assert bad == []


@pytest.mark.parametrize("flag", [
    "enable_texture_mapping", "enable_soft_shadow", "enable_bloom_effect",
    "enable_multiple_rays_per_pixel", "enable_depth_of_field",
    "enable_glossy_reflection"])
def test_unported_features_raise(flag):
    scene = ct.load_scene_prebuilt(ct.SceneType.Spheres, device="cpu")
    f = ct.Features(enable_shading=True, enable_recursive=True,
                    enable_accel_structure=True).replace(**{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.render_image(scene, ct.Camera(), f, ct.RenderParams(), 32, 16)


@pytest.mark.parametrize("change", [
    # transparency shadows (the closest blocker's transparency)
    dict(features=dict(enable_recursive=False, enable_transparency=True,
                       enable_hard_shadow=True)),
    dict(features=dict(enable_transparency=True)),
    # ported since: the frustum key pass and the coherence ray order
    dict(params=dict(sweep_exact_keys=False), renders=True),
    dict(params=dict(prims_axis="prims")),
    dict(params=dict(sweep_sort_bounce=True), renders=True)])
def test_unported_paths_raise(change, monkeypatch):
    """Paths outside the port raise NotImplementedError. The cases marked
    `renders` are the sweep knobs ported since (frustum keys, the
    coherence ray order): they render, and match the JAX package's render
    with its cluster path in interpret mode under the image rules (NaN
    masks agree; >= 99.5% of pixels within rtol 1e-4 / atol 2e-4)."""
    scene = ct.load_scene_prebuilt(ct.SceneType.Spheres, device="cpu")
    feats = {**dict(enable_shading=True, enable_recursive=True,
                    enable_accel_structure=True), **change.get("features", {})}
    params = change.get("params", {})
    f = ct.Features(**feats)
    p = ct.RenderParams().replace(**params)
    if not change.get("renders"):
        with pytest.raises(NotImplementedError):
            ct.render_image(scene, ct.Camera(), f, p, 32, 16)
        return
    from cge_tpu.ops import intersect as jint
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    ref = np.asarray(cge_tpu.render_image(
        cge_tpu.load_scene_prebuilt(cge_tpu.SceneType.Spheres),
        cge_tpu.Camera(), cge_tpu.Features(**feats),
        cge_tpu.RenderParams(**params), 32, 16))
    img = ct.render_image(scene, ct.Camera(), f, p, 32, 16).numpy()
    assert np.nanmax(ref) > 0.05
    assert (np.isnan(img) == np.isnan(ref)).mean() > 0.999
    both = np.isfinite(img) & np.isfinite(ref)
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    assert close.all(axis=-1).mean() >= 0.995
