"""The port's rasterized preview against the JAX package.

The GL matrices agree within 1e-6; the GL vertex lighting within 1e-6;
rasterize gives JAX's triangle ids and depths on the JAX tests' cases
(coverage, the depth test and its first-drawn tie rule, two-sided fill,
triangles behind the camera) and on a random soup of overlapping
triangles at equal depths across several tiles; shade_gouraud and
render_preview agree under the image rule (NaN masks agree, >= 99.5% of
pixels within rtol 1e-4 / atol 2e-4) on the 41x32 dragon stand-in
(tools/make_large_asset.py) with a point, a segment and a parallelogram
light, and on the Spheres scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu import raster as jr
from cge_tpu.raster.matrices import camera_matrices as jcam_matrices
from cge_tpu.scene.mesh_io import load_mesh
from cge_tpu.scene.scene import ParallelogramLight as JParallelogramLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SegmentLight as JSegmentLight
from cge_tpu.scene.scene import build_scene_arrays
from cge_tpu_torch import raster as pr
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.raster.matrices import camera_matrices as pcam_matrices
from tools.make_large_asset import write_obj

torch.set_num_threads(2)


def _port(jscene):
    leaves = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=jscene.all_opaque,
                            all_diffuse=jscene.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("raster") / "dragon.obj")
    write_obj(path, 41, 32)
    lights = [JPointLight((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)),
              JSegmentLight((1.5, 0.5, -0.6), (-1.0, 0.5, -0.5),
                            (0.9, 0.2, 0.1), (0.2, 1.0, 0.3)),
              JParallelogramLight((-0.2, 0.5, -0.8), (0.4, 0, 0),
                                  (0, 0, 0.4), (1, 0, 0), (0, 1, 0),
                                  (0, 0, 1), (0, 1, 1))]
    dragon = build_scene_arrays(load_mesh(path), [], lights)
    spheres = cge_tpu.load_scene_prebuilt(cge_tpu.SceneType.Spheres)
    return {"dragon": (dragon, _port(dragon)),
            "spheres": (spheres, _port(spheres))}


CAMS = [dict(), dict(rotation=(-0.3, 1.2, 0.1), distance=2.0,
                     look_at=(0.1, -0.2, 0.3), fovy=0.6)]


@pytest.mark.parametrize("kw", CAMS)
def test_matrices_match_jax(kw):
    for eye, center, up in (((1.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0)),
                            ((-0.5, 0.3, -2.0), (0.2, 0.1, 0.4),
                             (0.1, 0.9, 0.2))):
        np.testing.assert_allclose(
            pr.look_at(eye, center, up, device="cpu").numpy(),
            np.asarray(jr.look_at(np.array(eye), np.array(center), up)),
            atol=1e-6)
    for fovy, aspect in ((np.radians(50.0), 1.0), (0.3, 1.5)):
        np.testing.assert_allclose(
            pr.perspective(fovy, aspect, device="cpu").numpy(),
            np.asarray(jr.perspective(fovy, aspect)), rtol=1e-6, atol=1e-6)
    jv, jp = jcam_matrices(cge_tpu.Camera(**kw), 64, 48)
    pv, pp = pcam_matrices(ct.Camera(**kw), 64, 48, "cpu")
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6)
    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    a = jr.project_vertices(jnp.asarray(pts), jv, jp, 64, 48)
    b = pr.project_vertices(torch.from_numpy(pts), pv, pp, 64, 48)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("which", ["dragon", "spheres"])
def test_gl_lighting_matches_jax(scenes, which):
    js, ps = scenes[which]
    for a, b in zip(jr.gl_point_lights(js), pr.gl_point_lights(ps)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(pr.gl_vertex_colors(ps).numpy(),
                               np.asarray(jr.gl_vertex_colors(js)),
                               atol=1e-6)


def _both(xy, z, w, tris, width=16, height=16, **kw):
    a = jr.rasterize(jnp.asarray(xy, jnp.float32), jnp.asarray(z, jnp.float32),
                     jnp.asarray(w, jnp.float32), jnp.asarray(tris), width,
                     height, **kw)
    b = pr.rasterize(torch.tensor(xy, dtype=torch.float32),
                     torch.tensor(z, dtype=torch.float32),
                     torch.tensor(w, dtype=torch.float32), torch.tensor(tris),
                     width, height, **kw)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), atol=1e-6)
    return b[0].numpy(), b[1].numpy()


TRI = [[1.0, 1.0], [15.0, 1.0], [1.0, 15.0]]
CASES = {
    "coverage": (TRI, [0.0] * 3, [1.0] * 3, [[0, 1, 2]]),
    "depth_and_tie": ([[0, 0], [16, 0], [0, 16]] * 3,
                      [0.5] * 3 + [-0.5] * 6, [1.0] * 9,
                      [[0, 1, 2], [3, 4, 5], [6, 7, 8]]),
    "two_sided": ([[1.0, 1.0], [1.0, 15.0], [15.0, 1.0]], [0.0] * 3,
                  [1.0] * 3, [[0, 1, 2]]),
    "behind_camera": (TRI, [0.0] * 3, [1.0, -1.0, 1.0], [[0, 1, 2]]),
    "outside_clip_z": (TRI, [1.5] * 3, [1.0] * 3, [[0, 1, 2]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_cases_match_jax(case):
    tid, depth = _both(*CASES[case])
    if case == "coverage":
        assert tid[2, 2] == 0 and tid[14, 14] == -1
        assert (depth[tid == -1] == 1.0).all()
    if case == "depth_and_tie":
        assert tid[4, 4] == 1 and depth[4, 4] == -0.5   # closer, then first
    if case == "two_sided":
        assert tid[2, 2] == 0
    if case in ("behind_camera", "outside_clip_z"):
        assert (tid == -1).all()


@pytest.mark.parametrize("tile", [3, 8])
def test_rasterize_soup_ties_across_tiles(tile):
    """Overlapping triangles at z = 0 (exact ties at any barycentric
    weights) and a few disjoint ones in front, in tiles of 3 and 8 over
    several pixel chunks: the smallest index among a tile's minima, an
    earlier tile displaced only by a strictly closer z."""
    rng = np.random.default_rng(tile)
    n = 40
    xy = rng.uniform(-4, 28, (3 * n, 2)).astype(np.float32)
    z = np.zeros(3 * n, np.float32)
    front = rng.choice(n, 6, replace=False)
    for k, t in enumerate(front):          # one 4x4 cell each, disjoint
        cx, cy = 1 + 4 * (k % 3), 2 + 8 * (k // 3)
        xy[3 * t:3 * t + 3] = [[cx, cy], [cx + 3.5, cy], [cx, cy + 3.5]]
        z[3 * t:3 * t + 3] = -0.5
    w = np.ones(3 * n, np.float32)
    w[3 * int(front[0])] = -1.0            # dropped: behind the camera
    tris = np.arange(3 * n).reshape(n, 3)
    tid, depth = _both(xy, z, w, tris, 24, 20, pixel_chunk=128,
                       tri_tile=tile)
    assert len(np.unique(tid)) > 10
    assert set(front[1:]) <= set(np.unique(tid))
    assert int(front[0]) not in set(np.unique(tid))


def test_shade_gouraud_matches_jax():
    xy = [[0.0, 0.0], [16.0, 0.0], [0.0, 16.0], [4, 4], [12, 6], [6, 14]]
    z = [0.0, 0.0, 0.0, -0.2, -0.2, -0.2]
    tris = [[0, 1, 2], [3, 4, 5]]
    tid, _ = _both(xy, z, [1.0] * 6, tris)
    cols = np.eye(3, dtype=np.float32)[[0, 1, 2, 1, 2, 0]]
    a = jr.shade_gouraud(jnp.asarray(tid), jnp.asarray(xy, jnp.float32),
                         jnp.asarray(z), jnp.asarray(tris), jnp.asarray(cols))
    b = pr.shade_gouraud(torch.from_numpy(tid), torch.tensor(xy),
                         torch.tensor(z), torch.tensor(tris),
                         torch.from_numpy(cols))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    covered = tid >= 0
    np.testing.assert_allclose(b.numpy()[covered].sum(-1), 1.0, atol=1e-5)
    assert (b.numpy()[~covered] == 0).all()


def _image_rule(a, b):
    assert (np.isnan(a) == np.isnan(b)).mean() > 0.999
    both = np.isfinite(a) & np.isfinite(b)
    close = np.isclose(a, b, rtol=1e-4, atol=2e-4) | ~both
    assert close.all(axis=-1).mean() >= 0.995


@pytest.mark.parametrize("which,kw", [
    ("dragon", dict()), ("dragon", dict(show_lights=False)),
    ("spheres", dict(sphere_subdiv=2))])
def test_render_preview_matches_jax(scenes, which, kw):
    js, ps = scenes[which]
    lit = []
    for cam in CAMS:
        a = np.asarray(jr.render_preview(js, cge_tpu.Camera(**cam), 40, 32,
                                         **kw))
        b = pr.render_preview(ps, ct.Camera(**cam), 40, 32, **kw).numpy()
        assert b.shape == (32, 40, 3)
        _image_rule(a, b)
        lit.append(b.max())
    assert lit[0] > 0.05
