"""The port's debug views against the JAX package.

debug_trace replays every level and branch of a few rays (the closest hit
without an accel: K3's twin here); its levels must match JAX's: the same
number of levels and rays a level, hit masks equal, origins, directions,
t and colours at rtol 1e-4 / atol 2e-4 (NaN where JAX has NaN), with
mirrors, transparency continuations, shading off and soft shadows (the
light samples' key: ops.rng.prng_key(0), JAX's PRNGKey(0)).
traversal_debug's host replay, the MSAA / DoF / shadow sample sets and the
segment and projection helpers are held to JAX's on the same inputs.
Scenes: the 41x32 dragon stand-in (tools/make_large_asset.py), with
spheres and lights added, and the Spheres scene, built once by JAX and
carried across as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import bvh as jbvh
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SegmentLight as JSegmentLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu.viz import debug as jd
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import bvh as pbvh
from cge_tpu_torch.ops import intersect, rng
from cge_tpu_torch.viz import debug as pd
from tools.make_large_asset import write_obj

torch.set_num_threads(2)
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
TOL = dict(rtol=1e-4, atol=2e-4)


def _port(jscene):
    leaves = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=jscene.all_opaque,
                            all_diffuse=jscene.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viz") / "dragon.obj")
    write_obj(path, 41, 32)
    glass = SphereDef((0.0, 0.1, 0.0), 0.3,
                      Material(kd=np.float32([0.9, 0.3, 0.2]),
                               ks=np.float32([0.3, 0.3, 0.3]),
                               shininess=10.0, transparency=0.4))
    out = {
        "dragon": cge_tpu.load_scene_from_file(path, [JPointLight(*LIGHT)]),
        "glass": build_scene_arrays(load_mesh(path), [glass],
                                    [JPointLight(*LIGHT)]),
        "segment": build_scene_arrays(load_mesh(path), [], [
            JPointLight(*LIGHT),
            JSegmentLight((1.5, 0.5, -0.6), (-1.0, 0.5, -0.5),
                          (0.9, 0.2, 0.1), (0.2, 1.0, 0.3))]),
        "spheres": cge_tpu.load_scene_prebuilt(cge_tpu.SceneType.Spheres),
    }
    return {k: (v, _port(v)) for k, v in out.items()}


def _fan(n=3, scale=0.4):
    """An n x n fan of camera rays about the image centre, and one ray
    that misses everything."""
    g = ct.camera.pixel_grid(n, n, "cpu").reshape(-1, 2) * scale
    g = torch.cat([g, torch.tensor([[0.99, 0.99]])])
    return ct.Camera().generate_rays(g)


SHADE = dict(enable_shading=True, enable_hard_shadow=True)
# case: (scene, features, the fewest levels the fan must replay)
CASES = {
    "mirrors": ("dragon", dict(SHADE, enable_recursive=True,
                               enable_normal_interp=True), 3),
    "transparency": ("glass", dict(SHADE, enable_transparency=True), 2),
    "trans_rec": ("glass", dict(SHADE, enable_recursive=True,
                                enable_transparency=True), 3),
    "unshaded": ("glass", dict(enable_recursive=True), 2),
    "soft": ("segment", dict(SHADE, enable_soft_shadow=True,
                             enable_normal_interp=True), 1),
    "spheres": ("spheres", dict(SHADE, enable_recursive=True), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_debug_trace_matches_jax(scenes, case):
    which, flags, min_levels = CASES[case]
    js, ps = scenes[which]
    o, d = _fan()
    params = dict(ray_depth=2)
    ref = jd.debug_trace(js, o.numpy(), d.numpy(), cge_tpu.Features(**flags),
                         cge_tpu.RenderParams(**params))
    got = pd.debug_trace(ps, o, d, ct.Features(**flags),
                         ct.RenderParams(**params))
    assert [len(l.hit) for l in got] == [len(l.hit) for l in ref]
    assert len(got) >= min_levels
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.hit, a.hit)
        for k in ("origin", "dir", "t"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k), **TOL)
        np.testing.assert_allclose(b.color, a.color, equal_nan=True, **TOL)
    if which != "spheres":          # the Spheres scene's big sphere
        assert not got[0].hit[-1]
        np.testing.assert_array_equal(got[0].color[-1], [1.0, 0.0, 0.0])
        assert got[0].t[-1] == 100.0
    if case == "unshaded":
        assert (got[0].color[got[0].hit] == 1.0).all()


def test_debug_trace_key(scenes):
    """Another key draws other soft-shadow samples, the same as JAX's."""
    js, ps = scenes["segment"]
    flags = CASES["soft"][1]
    o, d = _fan(3)
    ref = jd.debug_trace(js, o.numpy(), d.numpy(), cge_tpu.Features(**flags),
                         cge_tpu.RenderParams(), key=jax.random.PRNGKey(5),
                         depth=0)
    got = pd.debug_trace(ps, o, d, ct.Features(**flags), ct.RenderParams(),
                         key=rng.prng_key(5), depth=0)
    base = pd.debug_trace(ps, o, d, ct.Features(**flags), ct.RenderParams(),
                          depth=0)
    assert len(got) == len(ref) == 1
    np.testing.assert_allclose(got[0].color, ref[0].color, **TOL)
    assert not np.allclose(got[0].color, base[0].color)


@pytest.mark.parametrize("which,sah", [("dragon", False), ("glass", True)])
def test_traversal_debug_matches_jax(scenes, which, sah):
    js, ps = scenes[which]
    jb = jbvh.build_reference_bvh(js, sah_binning=sah, use_native=False)
    pb = pbvh.build_reference_bvh(ps, sah_binning=sah, use_native=False)
    o, d = _fan(3)
    rays = [(o[i].numpy(), d[i].numpy()) for i in range(o.shape[0])]
    rays.append((np.array([3.0, 2.0, -3.0], np.float32),
                 np.array([0.0, 0.0, 1.0], np.float32)))
    n_tri = 0
    for oo, dd in rays:
        a = jd.traversal_debug(jb, js, oo, dd)
        b = pd.traversal_debug(pb, ps, torch.from_numpy(oo), dd)
        for k in a._fields:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(y, x, err_msg=k)
        n_tri += b.tri is not None
    assert n_tri > 0 and b.tri is None


def test_sample_sets_match_jax():
    params = dict(rays_per_pixel_side=3, samples_dof=5)
    jc, pc = cge_tpu.Camera(), ct.Camera()
    a = jd.debug_ray_samples(0.1, -0.2, jc, cge_tpu.RenderParams(**params),
                             64, 48)
    b = pd.debug_ray_samples(0.1, -0.2, pc, ct.RenderParams(**params), 64, 48,
                             device="cpu")
    a2 = jd.debug_dof_rays(0.1, -0.2, jc, cge_tpu.RenderParams(**params))
    b2 = pd.debug_dof_rays(0.1, -0.2, pc, ct.RenderParams(**params),
                           device="cpu")
    for x, y in zip((*a, *a2), (*b, *b2)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)
    assert b[0].shape == (9, 3) and b2[0].shape == (5, 3)
    assert np.std(b2[0].numpy(), axis=0).max() > 0


def test_debug_shadow_rays_match_jax(scenes):
    js, ps = scenes["glass"]
    o, d = _fan(4)
    feats = dict(SHADE)
    hits = intersect.closest_hit(ps, o, d,
                                        torch.full((o.shape[0],), torch.inf))
    t = torch.where(hits.hit, hits.t, 1.0)
    # one light in front, one behind the dragon (from the camera)
    light = torch.tensor([[-1.0, 1.0, -1.0], [0.5, -0.3, 2.5]])
    pos = light[torch.arange(o.shape[0]) % 2]
    col = torch.rand(o.shape[0], 3, generator=torch.Generator().manual_seed(1))
    a = jd.debug_shadow_rays(js, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()), jnp.asarray(t.numpy()),
                             jnp.asarray(pos.numpy()),
                             jnp.asarray(col.numpy()),
                             cge_tpu.Features(**feats),
                             cge_tpu.RenderParams())
    b = pd.debug_shadow_rays(ps, o, d, t, pos, col, ct.Features(**feats),
                             ct.RenderParams())
    np.testing.assert_array_equal(b.visible, np.asarray(a.visible))
    np.testing.assert_allclose(b.origin, a.origin, **TOL)
    np.testing.assert_array_equal(b.target, a.target)
    np.testing.assert_array_equal(b.color, a.color)
    assert 0 < b.visible.sum() < len(b.visible)


def test_segment_and_projection_helpers_match_jax(scenes):
    js, ps = scenes["dragon"]
    for tri in (0, 7, 100):
        for a, b in zip(jd.normal_segments(js, tri, 0.1),
                        pd.normal_segments(ps, tri, 0.1)):
            np.testing.assert_array_equal(b, a)
    pb = pbvh.build_reference_bvh(ps)
    lo, hi = pb.debug_level_boxes(2)
    for a, b in zip(jd.aabb_segments(lo, hi), pd.aabb_segments(lo, hi)):
        np.testing.assert_array_equal(b, a)
    cams = [dict(), dict(rotation=(-0.3, 1.2, 0.1), distance=2.0,
                         look_at=(0.1, -0.2, 0.3), aspect=1.5)]
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    for kw in cams:
        jc, pc = cge_tpu.Camera(**kw), ct.Camera(**kw)
        (jp, jf), (pp, pf) = (jd.project_points(jc, pts, 64, 48),
                              pd.project_points(pc, pts, 64, 48))
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_allclose(pp[pf], jp[jf], rtol=1e-4, atol=1e-3)
        a, b = jd.aabb_segments(lo, hi)
        img = np.zeros((48, 64, 3), np.float32)
        ja = jd.draw_segments(img, jc, a, b, color=(0, 1, 0))
        pa = pd.draw_segments(img, pc, a, b, color=(0, 1, 0))
        assert (img == 0).all() and pa[..., 1].sum() > 10
        assert (pa == ja).all(axis=-1).mean() >= 0.999
    # a drawn debug ray starting behind the near plane is clipped
    o, d = _fan(1)
    ray = pd.draw_segments(img, ct.Camera(), o[:1].numpy(),
                           (o[:1] + 100 * d[:1]).numpy())
    assert ray[..., 1].sum() > 0
