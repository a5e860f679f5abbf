"""The port's profiling and checkpoint utilities and the camera's mouse
handlers against the JAX package.

count_rays equals JAX's count in every mode (chain, TRANS+REC tree and its
all-diffuse collapse, glossy, MSAA, DoF, soft shadows); timed_render gives
render_image's image with its counters; timed_bvh_build gives the
reference BVH and the reference's prints; sweep_roofline has JAX's keys at
the card's peak (tools/roofline.py); trace writes a Chrome trace; a
checkpoint round trip keeps every tensor, and a train run resumed from a
checkpoint equals the uninterrupted run, from parameters carried across
from the JAX package with interop.params_from_numpy.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.diff.gradients import scene_params as jscene_params
from cge_tpu.ops import bvh as jbvh
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SegmentLight as JSegmentLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu.utils import profiling as jprof
from cge_tpu_torch import interop
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.render.wavefront import trace
from cge_tpu_torch.ops import rng
from cge_tpu_torch.tools import roofline
from cge_tpu_torch.utils import checkpoint
from cge_tpu_torch.utils import profiling as pprof
from tools.make_large_asset import write_obj

torch.set_num_threads(2)
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def _port(jscene):
    leaves = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=jscene.all_opaque,
                            all_diffuse=jscene.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("utils") / "dragon.obj")
    write_obj(path, 41, 32)
    lights = [JPointLight(*LIGHT), JPointLight((1.0, 1.0, 1.0), (1, 1, 1)),
              JSegmentLight((1.5, 0.5, -0.6), (-1.0, 0.5, -0.5),
                            (0.9, 0.2, 0.1), (0.2, 1.0, 0.3))]
    glass = SphereDef((0.0, 0.1, 0.0), 0.3,
                      Material(kd=np.float32([0.9, 0.3, 0.2]),
                               ks=np.float32([0.3, 0.3, 0.3]),
                               transparency=0.4))
    diffuse_glass = SphereDef((0.0, 0.1, 0.0), 0.3,
                              Material(kd=np.float32([0.9, 0.3, 0.2]),
                                       transparency=0.4))
    out = {
        "dragon": cge_tpu.load_scene_from_file(path, [JPointLight(*LIGHT)]),
        "lights": build_scene_arrays(load_mesh(path), [], lights),
        "glass": build_scene_arrays(load_mesh(path), [glass], lights),
        "diffuse": build_scene_arrays([], [diffuse_glass], lights),
    }
    return {k: (v, _port(v)) for k, v in out.items()}


BASE = dict(enable_shading=True, enable_hard_shadow=True)
MODES = {
    "unshaded": ("dragon", dict(enable_shading=True), {}),
    "chain": ("lights", dict(BASE, enable_recursive=True), {}),
    "chain_glass": ("glass", dict(BASE, enable_recursive=True), {}),
    "transparency": ("glass", dict(BASE, enable_transparency=True), {}),
    "tree": ("glass", dict(BASE, enable_recursive=True,
                           enable_transparency=True), {}),
    "tree_all_diffuse": ("diffuse", dict(BASE, enable_recursive=True,
                                         enable_transparency=True), {}),
    "glossy": ("lights", dict(BASE, enable_recursive=True,
                              enable_glossy_reflection=True),
               dict(ray_depth=3)),
    "msaa": ("lights", dict(BASE, enable_multiple_rays_per_pixel=True),
             dict(rays_per_pixel_side=2)),
    "dof": ("lights", dict(BASE, enable_depth_of_field=True),
            dict(samples_dof=3)),
    "msaa_dof_soft": ("glass", dict(BASE, enable_soft_shadow=True,
                                    enable_multiple_rays_per_pixel=True,
                                    enable_depth_of_field=True),
                      dict(segment_light_samples=9)),
    "soft_only": ("lights", dict(enable_shading=True,
                                 enable_soft_shadow=True), {}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_count_rays_matches_jax(scenes, mode):
    which, flags, params = MODES[mode]
    js, ps = scenes[which]
    for w, h in ((8, 8), (24, 16)):
        ref = jprof.count_rays(w, h, js, cge_tpu.Features(**flags),
                               cge_tpu.RenderParams(**params))
        got = pprof.count_rays(w, h, ps, ct.Features(**flags),
                               ct.RenderParams(**params))
        assert got == ref and got >= w * h


def test_timed_render(scenes):
    _, ps = scenes["dragon"]
    f = ct.Features(**BASE, enable_normal_interp=True)
    p = ct.RenderParams()
    img, stats = pprof.timed_render(ps, ct.Camera(), f, p, 16, 12, seed=2)
    np.testing.assert_array_equal(
        img, ct.render_image(ps, ct.Camera(), f, p, 16, 12, 2).numpy())
    assert img.shape == (12, 16, 3) and stats.wall_ms > 0
    assert stats.primary_rays == 192
    assert stats.total_rays == pprof.count_rays(16, 12, ps, f, p) == 384
    assert stats.rays_per_s > 0 and "Mrays/s" in str(stats)


@pytest.mark.parametrize("sah", [False, True])
def test_timed_bvh_build(scenes, sah):
    js, ps = scenes["glass"]
    bvh, stats = pprof.timed_bvh_build(ps, sah_binning=sah)
    ref = jbvh.build_reference_bvh(js, sah_binning=sah)      # native, both
    np.testing.assert_array_equal(bvh.node_meta, ref.node_meta)
    assert (stats.num_levels, stats.num_leaves, stats.max_per_leaf) == (
        ref.num_levels, ref.num_leaves, ref.max_per_leaf)
    assert stats.build_ms > 0
    text = str(stats).splitlines()
    assert text[0].startswith("BVH generation took ")
    assert text[1] == f"Max triangles per node is: {ref.max_per_leaf}"


def test_sweep_roofline_keys():
    """JAX's keys, at the card's float32 peak and K3's operations a pair
    (tools/roofline.py), not the TPU's constants."""
    ref = jprof.sweep_roofline(1 << 20, 1 << 10, 0.5)
    got = pprof.sweep_roofline(1 << 20, 1 << 10, 0.5)
    assert got.keys() == ref.keys()
    assert got["pair_tests"] == 1 << 30
    assert got["slots_per_pair"] == (roofline.SWEEP_PLANE_OPS
                                     + roofline.SWEEP_EDGE_OPS)
    assert got["pairs_per_s"] == (1 << 30) / 0.5
    assert got["fraction_of_peak"] == pytest.approx(
        got["achieved_flops"] / roofline.FP32_PEAK)
    assert got["attainable_pairs_per_s"] == pytest.approx(
        roofline.FP32_PEAK / 2 / got["slots_per_pair"])
    assert 0 < got["fraction_of_attainable"] < 1
    assert pprof.sweep_roofline(1, 1, 0.0)["pairs_per_s"] == 0.0


def test_trace_writes_a_file(scenes, tmp_path):
    _, ps = scenes["dragon"]
    with pprof.trace(str(tmp_path / "tr")) as prof:
        ct.render_image(ps, ct.Camera(), ct.Features(**BASE),
                        ct.RenderParams(), 8, 8)
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("closest_tris" in str(e.get("name", "")) or
               "aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("kw", [dict(), dict(rotation=(0.1, -2.0, 0.3),
                                             look_at=(0.5, 0.0, -0.2))])
def test_camera_handlers_match_jax(kw):
    """The trackball's mouse handlers (trackball.cpp:136-164)."""
    j, p = cge_tpu.Camera(**kw), ct.Camera(**kw)
    for op, args in (("orbit", (40.0, 10.0)), ("orbit", (0.0, 1e4)),
                     ("pan", (7.0, -3.0)), ("zoom", (2.0,)),
                     ("zoom", (1e9,)), ("zoom", (-1e9,))):
        a, b = getattr(j, op)(*args), getattr(p, op)(*args)
        assert b.rotation == a.rotation and b.distance == a.distance
        np.testing.assert_allclose(b.look_at, a.look_at, rtol=1e-6,
                                   atol=1e-7)
    assert p.orbit(0.0, 1e4).rotation[0] == -np.pi / 2
    for axis in ("forward", "up", "left"):
        np.testing.assert_allclose(getattr(p, axis)("cpu").numpy(),
                                   np.asarray(getattr(j, axis)()),
                                   rtol=1e-6, atol=1e-7)
    assert p.half_screen_h == pytest.approx(float(j.half_screen_h), 1e-7)


def test_checkpoint_roundtrip(scenes, tmp_path):
    _, ps = scenes["glass"]
    tree = {"params": ct.scene_params(ps), "step": 7,
            "momentum": [torch.ones(3), torch.arange(4)]}
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(d)
    checkpoint.save(d, 3, {"step": 3})
    path = checkpoint.save(d, 7, tree)
    assert os.path.basename(path) == "step_7"
    checkpoint.save(d, 7, tree)                 # overwrite in place
    assert checkpoint.latest_step(d) == 7
    back = checkpoint.restore(d)
    assert back["step"] == 7 and torch.equal(back["momentum"][1],
                                             torch.arange(4))
    for k, v in tree["params"].items():
        assert torch.equal(back["params"][k], v), k
    assert checkpoint.restore(d, step=3) == {"step": 3}
    assert checkpoint.restore(d, device="cpu")["params"]["vertices"].device \
        == torch.device("cpu")


def test_resumed_train_equals_uninterrupted(scenes, tmp_path):
    """Three SGD steps from the JAX package's scene_params, carried across
    with interop.params_from_numpy: resumed from the checkpoint after the
    first step, the parameters equal the uninterrupted run's bit for
    bit."""
    js, ps = scenes["lights"]
    start = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jscene_params(js).items()},
        device="cpu")
    scene = ct.with_params(ps, start)
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(10, 10, "cpu").reshape(-1, 2))
    feats = ct.Features(**BASE, enable_normal_interp=True)
    rp = ct.RenderParams()
    target_scene = dataclasses.replace(scene, mat_kd=scene.mat_kd * 0.8)
    with torch.no_grad():
        target = torch.nan_to_num(trace(target_scene, o, d, feats, rp,
                                        rng.prng_key(0)))

    def step(s):
        _, g = ct.loss_and_grads(s, o, d, target, feats, rp)
        return ct.sgd_step(s, g, 0.5)

    run = scene
    for _ in range(3):
        run = step(run)
    d_ = str(tmp_path / "run")
    checkpoint.save(d_, 1, ct.scene_params(step(scene)))
    resumed = ct.with_params(scene, checkpoint.restore(d_))
    for _ in range(2):
        resumed = step(resumed)
    for k, v in ct.scene_params(run).items():
        assert torch.equal(ct.scene_params(resumed)[k], v), k
    assert not torch.equal(run.mat_kd, scene.mat_kd)
