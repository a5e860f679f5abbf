"""The port's multi-device paths (cge_tpu_torch.parallel) against the JAX
package's (cge_tpu.parallel.sharding, intersect.closest_hit with
prims_axis) on the CPU.

The port runs in gloo worlds of 2 and 4 rank processes
(tests/torch_sharding_ranks.py, started by parallel.launch.run_ranks; one
world of each size per module, all jobs in it); JAX runs here on
conftest's 8 virtual CPU devices, its cluster sweep in interpret mode
(FORCE_CLUSTER_INTERPRET) where the accel is on. The scenes are built
once by JAX from in-repo stand-ins (tools/make_large_asset.write_obj) and
carried across as numpy:
  (a) the prims-sharded cluster sweep at prims = 2 on a 20-cluster stack
      and on a field-major 5-cluster one (padded to 6: odd shards of 3,
      each padded again to the 4 clusters a visit), against
      JAX's closest_hit under shard_map: hit masks, sphere flags and
      global perm-space ids exactly, t to rtol 1e-5 / atol 2e-6 (XLA's
      FMAs, the single-device cluster sweep's rule);
  (b) the prims-sharded brute sweep likewise (ids exactly, t to rtol
      1e-5 / atol 2e-6, ROADMAP section 3's brute-path rounding);
  (c) render_image_sharded at meshes (rays, prims) = (4, 1), (1, 2) and
      (2, 2), accel on and off, and a 21x15 frame the rays axis does not
      divide, each against JAX's render_image_sharded on the same mesh
      under the image rule (NaN masks agree, >= 99.5% of pixels within
      rtol 1e-4 / atol 2e-4), one with soft shadows (samples keyed by
      global ray id); the rays-only mesh equal bit for bit to the port's
      own render_image with a trace_chunk that divides the shard;
  (e) a prims_axis that no bound mesh names, or of the wrong size, raises.
The train step is in test_torch_sharding_train.py.
"""

import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.ops import intersect as jint
from cge_tpu.ops.pallas.cluster_sweep import pack_cluster_tiles
from cge_tpu.parallel import sharding as jshard
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import ParallelogramLight as JParLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import intersect as pint
from cge_tpu_torch.parallel.launch import run_ranks
from torch_sharding_ranks import run_worlds
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
PAR = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4), (1.0, 0.2, 0.2),
       (0.2, 1.0, 0.2), (0.2, 0.2, 1.0), (1.0, 1.0, 0.2))
HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True)
SOFT = dict(enable_shading=True, enable_soft_shadow=True,
            enable_normal_interp=True)
W, H = 32, 16
# a trace_chunk that divides every shard of a 32x16 frame (128 rays at
# rays = 4), so the rays-only render's chunks are render_image's
CHUNK = 64
# (name, scene, features, accel, mesh, compare): "jax" against JAX's
# render_image_sharded on the same mesh, "exact" bit for bit against the
# port's render_image, "image" against it under the image rule. A sharded
# frame keys pixel p's samples by (prng_key(seed), p), as JAX's sharded
# render does, and render_image by (fold_in(key, 3), tile-order id), so the
# soft frame is held to JAX's sharded frame only. Each JAX comparison
# compiles a sharded render (13-22 s on this CPU, in threads beside the
# rank worlds), and every frame meets JAX's.
RENDERS = (
    ("off_4x1", "dragon", HEADLINE, False, (4, 1), ("jax", "exact")),
    ("on_4x1", "dragon", HEADLINE, True, (4, 1), ("jax", "exact")),
    ("off_1x2", "dragon", HEADLINE, False, (1, 2), ("jax", "image")),
    ("on_1x2", "dragon", HEADLINE, True, (1, 2), ("jax", "image")),
    ("on_2x2", "dragon", HEADLINE, True, (2, 2), ("jax", "image")),
    ("off_2x2", "dragon", HEADLINE, False, (2, 2), ("jax", "image")),
    ("soft_2x2", "soft", SOFT, False, (2, 2), ("jax",)),
)
# the frame the rays axis does not divide: 21 x 15 = 315 rays over 4 ranks
PAD = (21, 15)
# (name, scene, accel layout or None for the brute sweep): 20 clusters in
# shards of 10; 5 clusters padded to 6, shards of 3, field-major (4
# clusters a visit: each shard pads to 4 again)
SWEEPS = (("dragon_triangle", "dragon", "triangle"),
          ("odd_field", "odd", "field"),
          ("dragon_brute", "dragon", None))


def _scene(path, spheres=(), lights=(JPointLight(*LIGHT),)):
    return build_scene_arrays(load_mesh(path), list(spheres), list(lights))


def _port(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k))
                             for k in TENSOR_FIELDS},
                            all_opaque=js.all_opaque,
                            all_diffuse=js.all_diffuse, device="cpu")


def _save_scene(js, path):
    np.savez(path, all_opaque=js.all_opaque, all_diffuse=js.all_diffuse,
             **{k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS})
    return path


def _rays(js):
    """One batch: the primary rays of a 16x16 camera, then 384 rays from
    inside the scene box in scattered directions with a dead third (tmax
    -1)."""
    o, d = cge_tpu.Camera().generate_rays(jpixel_grid(16, 16).reshape(-1, 2))
    rng = np.random.default_rng(3)
    v = np.asarray(js.vertices)
    n = 384
    ob = rng.uniform(v.min(0), v.max(0), (n, 3)).astype(np.float32)
    db = rng.normal(size=(n, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 3 == 2, -1.0, np.inf).astype(np.float32)
    return {"o": np.concatenate([np.array(o), ob]),
            "d": np.concatenate([np.array(d), db]),
            "tmax": np.concatenate([np.full(o.shape[0], np.inf, np.float32),
                                    tmax])}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_scenes")
    write_obj(str(d / "dragon.obj"), 41, 32)        # 2,560 tris, 20 clusters
    write_obj(str(d / "odd.obj"), 11, 32)           # 640 tris, 5 clusters
    spheres = [SphereDef((0.0, 0.1, 0.0), 0.3,
                         Material(kd=np.float32([0.9, 0.3, 0.2]),
                                  ks=np.float32([0.4, 0.4, 0.4]),
                                  shininess=12.0)),
               SphereDef((0.55, 0.45, -0.7), 0.2,
                         Material(kd=np.float32([0.2, 0.3, 0.9])))]
    return {"dragon": _scene(str(d / "dragon.obj"), spheres),
            "odd": _scene(str(d / "odd.obj")),
            "soft": _scene(str(d / "dragon.obj"), spheres,
                           (JPointLight(*LIGHT), JParLight(*PAR)))}


def _jax_accel(js, layout):
    aabbs, tiles = pack_cluster_tiles(js.vertices, js.tris, js.cluster_perm,
                                      hbm=layout == "field")
    return jint.Accel(perm=js.cluster_perm, aabbs=aabbs, tiles=tiles)


def _jax_sweep(js, layout):
    """JAX's closest_hit with prims_axis under shard_map over 2 devices;
    ids in perm space with the accel."""
    o, d, tmax = (jnp.asarray(v) for v in _rays(js).values())
    accel = None if layout is None else _jax_accel(js, layout)
    mesh = jshard.make_mesh(("prims",), (2,), devices=jax.devices()[:2])

    def f(o, d, t):
        return jint.closest_hit(js, o, d, t, prims_axis="prims",
                                prims_axis_size=2, accel=accel,
                                perm_ids=accel is not None)

    ref = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                    check_vma=False)(o, d, tmax)
    return {k: np.asarray(getattr(ref, k)) for k in
            ("hit", "t", "is_sphere", "prim")}


def _jax_render(js, feats, mesh, size=(W, H)):
    jmesh = jshard.make_mesh(("rays", "prims"), mesh,
                             devices=jax.devices()[:mesh[0] * mesh[1]])
    return np.asarray(jshard.render_image_sharded(
        js, cge_tpu.Camera(), cge_tpu.Features(**feats),
        cge_tpu.RenderParams(trace_chunk=CHUNK), *size, jmesh, seed=3))


@pytest.fixture(scope="module")
def results(scenes, tmp_path_factory):
    """Every job of this module: the port's in a 4-rank and a 2-rank gloo
    world, JAX's here; all of them side by side (JAX compiles its sharded
    renders in threads). FORCE_CLUSTER_INTERPRET changes only the
    accel-on paths, so it is on for every JAX job."""
    tmp = str(tmp_path_factory.mktemp("shard_ranks"))
    paths = {k: _save_scene(v, os.path.join(tmp, f"{k}.npz"))
             for k, v in scenes.items()}
    rays = {f"{name}/{k}": v for name in ("dragon", "odd")
            for k, v in _rays(scenes[name]).items()}
    jobs = {2: [], 4: []}
    for name, scene, feats, accel, mesh, _ in RENDERS:
        jobs[mesh[0] * mesh[1]].append(dict(
            kind="render", name=name, scene=scene, mesh=mesh, width=W,
            height=H, seed=3, params=dict(trace_chunk=CHUNK),
            features={**feats, "enable_accel_structure": accel}))
    # a frame the rays axis does not divide
    jobs[4].append(dict(kind="render", name="pad_4x1", scene="dragon",
                        mesh=(4, 1), width=PAD[0], height=PAD[1],
                        features=HEADLINE, params=dict(trace_chunk=CHUNK)))
    for name, scene, layout in SWEEPS:
        jobs[2].append(dict(kind="sweep", name=name, scene=scene,
                            mesh=(1, 2), accel=layout is not None,
                            layout=layout, rays=scene))
    jobs[2].append(dict(kind="raises", name="raises", scene="dragon",
                        mesh=(1, 2)))
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(6) as ex:
        mp.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
        ranks = run_worlds(ex, tmp, paths, rays, jobs)
        ref = {name: ex.submit(_jax_sweep, scenes[scene], layout)
               for name, scene, layout in SWEEPS}
        ref.update({name: ex.submit(
            _jax_render, scenes[scene],
            {**feats, "enable_accel_structure": accel}, mesh)
            for name, scene, feats, accel, mesh, compare in RENDERS
            if "jax" in compare})
        ref["pad_4x1"] = ex.submit(_jax_render, scenes["dragon"], HEADLINE,
                                   (4, 1), PAD)
        return ranks(), {k: v.result() for k, v in ref.items()}


def _image_rule(img, ref):
    assert np.nanmax(ref) > 0.05
    assert (np.isnan(img) == np.isnan(ref)).mean() > 0.999
    both = np.isfinite(img) & np.isfinite(ref)
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    assert close.all(axis=-1).mean() >= 0.995


@pytest.mark.parametrize("name,scene,layout", SWEEPS)
def test_prims_sweep_matches_jax(scenes, results, name, scene, layout):
    ranks, jref = results
    js = scenes[scene]
    if layout is not None:
        assert js.cluster_perm.shape[0] == (20 if scene == "dragon" else 5)
    ref = jref[name]
    got = {k: ranks[f"{name}/{k}"] for k in
           ("hit", "t", "is_sphere", "prim")}
    hit = ref["hit"]
    np.testing.assert_array_equal(got["hit"], hit)
    assert hit[:256].any() and hit[256:].any() and not hit[256:].all()
    np.testing.assert_array_equal(got["is_sphere"][hit],
                                  ref["is_sphere"][hit])
    np.testing.assert_array_equal(got["prim"][hit], ref["prim"][hit])
    np.testing.assert_allclose(got["t"][hit], ref["t"][hit], rtol=1e-5,
                               atol=2e-6)
    if scene == "dragon":
        assert ref["is_sphere"][hit].any()
    if layout is not None:
        # both ranks' slices hit: the reduction saw ids from each shard
        C = js.cluster_perm.shape[1]
        shard = -(-js.cluster_perm.shape[0] // 2) * C
        tri = got["prim"][hit & ~got["is_sphere"]]
        assert (tri < shard).any() and (tri >= shard).any()


def test_prims_sweep_against_single_device(scenes, results):
    """The same sweeps against the port's single-device closest_hit: hit
    masks and t equal; ids equal off exact-t ties (the tie rules differ:
    the largest global id against visit or id order)."""
    for name, scene, layout in SWEEPS:
        ps = _port(scenes[scene])
        accel = pint.build_accel(ps, layout) if layout else None
        o, d, tmax = (torch.from_numpy(v) for v in _rays(scenes[scene])
                      .values())
        ref = pint.closest_hit(ps, o, d, tmax, accel, perm_ids=True)
        got = {k: results[0][f"{name}/{k}"] for k in ("hit", "t", "prim")}
        np.testing.assert_array_equal(got["hit"], ref.hit.numpy())
        np.testing.assert_array_equal(got["t"], ref.t.numpy())
        h = got["hit"]
        assert (got["prim"][h] == ref.prim.numpy()[h]).mean() > 0.99


@pytest.mark.parametrize("name,scene,feats,accel,mesh,compare", RENDERS)
def test_render_image_sharded(scenes, results, name, scene, feats, accel,
                              mesh, compare):
    img = results[0][name]
    assert img.shape == (H, W, 3)
    f = {**feats, "enable_accel_structure": accel}
    params = dict(trace_chunk=CHUNK)
    if "jax" in compare:
        _image_rule(img, results[1][name])
    if "jax" in compare and len(compare) == 1:
        return
    single = ct.render_image(_port(scenes[scene]), ct.Camera(),
                             ct.Features(**f), ct.RenderParams(**params), W,
                             H).numpy()
    if "exact" in compare:
        np.testing.assert_array_equal(np.isnan(img), np.isnan(single))
        np.testing.assert_array_equal(np.nan_to_num(img),
                                      np.nan_to_num(single))
    else:
        _image_rule(img, single)


def test_render_with_pad_rays(scenes, results):
    """315 rays over 4 rank shards of 79: the pad ray is cut away and the
    frame is the single-device frame, and JAX's sharded frame."""
    img = results[0]["pad_4x1"]
    assert img.shape == (15, 21, 3)
    single = ct.render_image(_port(scenes["dragon"]), ct.Camera(),
                             ct.Features(**HEADLINE),
                             ct.RenderParams(trace_chunk=CHUNK), *PAD).numpy()
    _image_rule(img, single)
    _image_rule(img, results[1]["pad_4x1"])


def test_prims_axis_outside_a_mesh_raises(scenes, results):
    ranks = results[0]
    ps = _port(scenes["dragon"])
    p = ct.RenderParams(prims_axis="prims", prims_axis_size=2)
    with pytest.raises(ValueError, match="'prims'"):
        ct.render_image(ps, ct.Camera(), ct.Features(**HEADLINE), p, 8, 8)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="'prims'"):
        pint.closest_hit(ps, o, d, torch.full((4,), torch.inf),
                         prims_axis="prims")
    # inside a bound (1, 2) mesh: the wrong size and an unknown name
    assert "2 ranks, prims_axis_size says 4" in str(ranks["raises/size"])
    assert "'tris' is not bound" in str(ranks["raises/name"])


def test_collectives_were_counted(results):
    calls, nbytes = results[0]["collectives"]
    assert calls > 0 and nbytes > 0


def test_run_ranks_reports_a_failed_rank(tmp_path):
    code = "import os, sys; sys.exit(int(os.environ['RANK']))"
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] failed"):
        run_ranks([sys.executable, "-c", code], 2, 60)


def test_run_ranks_kills_on_timeout():
    code = ("import os, time\n"
            "if os.environ['RANK'] == '1': time.sleep(60)")
    with pytest.raises(RuntimeError, match="timed out"):
        run_ranks([sys.executable, "-c", code], 2, 3)
    # no rank survives its run
    out = subprocess.run(["pgrep", "-f", "time.sleep\\(60\\)"],
                         capture_output=True, text=True)
    assert out.stdout.strip() == ""
