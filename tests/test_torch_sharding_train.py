"""The port's sharded train step (cge_tpu_torch.parallel.train_step_sharded
and loss_and_grads_sharded) against its single-device step and against
the JAX package's train_step_sharded, on the CPU.

The scenes are test_torch_gradients.py's: the 9x8 dragon stand-in (128
triangles) with two spheres and a point light, 12x12 camera rays and a
seeded target; the feature sets that stand-in carries: hard shadows with
recursion and interpolated normals, a parallelogram light's soft shadows,
the textured body, and the TRANS+REC tree (glass body, ray_depth 3). The
port runs every set at meshes (rays, prims) = (2, 1), (1, 2) and (2, 2) in
gloo rank worlds (tests/torch_sharding_ranks.py); each step equals the
port's single-device loss_and_grads + sgd_step: the loss within 1e-6
relative, every gradient within 1e-4 of its norm (the mean's and the
all-reduce's summation order), and the new leaves are sgd_step's. JAX's
train_step_sharded (conftest's virtual CPU devices) compiles in 25-40 s a
mesh and set on this CPU, the tree's in 191 s at (2, 1) (measured beside
two other busy processes), so each set but the tree meets it, at one
mesh: the hard-shadow set at (2, 1)
with 11x11 rays (the rays axis does not divide them: one zero pad ray
counts in the loss, as in JAX), the soft set at (1, 2) and the textured
set at (2, 2); the tree and the other meshes meet JAX through the
single-device step, which
test_torch_gradients.py holds to jax.value_and_grad. There the loss
within test_torch_gradients.py's LOSS_RTOL and each updated leaf within
its gradient rule (rtol 2e-3, atol 1e-4 x max |g|) times lr, plus the
update's own f32 rounding.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.parallel import sharding as jshard
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import ParallelogramLight as JParLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.tools.common import write_textured_obj, write_variant_obj
from torch_sharding_ranks import run_worlds
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
PAR = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4), (1.0, 0.2, 0.2),
       (0.2, 1.0, 0.2), (0.2, 0.2, 1.0), (1.0, 1.0, 0.2))
FEATURES = {
    "hard": dict(enable_shading=True, enable_hard_shadow=True,
                 enable_recursive=True, enable_normal_interp=True),
    "soft": dict(enable_shading=True, enable_soft_shadow=True,
                 enable_normal_interp=True),
    "texture": dict(enable_shading=True, enable_hard_shadow=True,
                    enable_recursive=True, enable_normal_interp=True,
                    enable_texture_mapping=True,
                    enable_bilinear_texture_filtering=True),
    "transrec": dict(enable_shading=True, enable_hard_shadow=True,
                     enable_recursive=True, enable_transparency=True,
                     enable_normal_interp=True),
}
PARAMS = {"transrec": dict(ray_depth=3, extra_transparency_unroll=2)}
LOSS_RTOL = {"transrec": 1e-4}
MESHES = ((2, 1), (1, 2), (2, 2))
# (set, mesh, camera side) against JAX's train_step_sharded
JAX_CASES = (("hard", (2, 1), 11), ("soft", (1, 2), 12),
             ("texture", (2, 2), 12))
LR = 0.1
SEED = 5


def _rays(side):
    o, d = cge_tpu.Camera().generate_rays(
        jpixel_grid(side, side).reshape(-1, 2))
    target = np.random.default_rng(SEED).uniform(
        0.0, 0.5, (side * side, 3)).astype(np.float32)
    return np.array(o), np.array(d), target


def _port(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k))
                             for k in TENSOR_FIELDS},
                            all_opaque=js.all_opaque,
                            all_diffuse=js.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    spheres = [SphereDef((0.0, 0.1, 0.0), 0.3,
                         Material(kd=np.float32([0.9, 0.3, 0.2]),
                                  ks=np.float32([0.4, 0.4, 0.4]),
                                  shininess=12.0)),
               SphereDef((0.55, 0.45, -0.7), 0.2,
                         Material(kd=np.float32([0.2, 0.3, 0.9])))]
    out = {}
    for which in FEATURES:
        path = str(tmp_path_factory.mktemp(f"train_{which}") / "dragon.obj")
        if which == "texture":
            write_textured_obj(path, 9, 8)
        elif which == "transrec":
            write_variant_obj(path, 9, 8, "glass")
        else:
            write_obj(path, 9, 8)
        lights = [JPointLight(*LIGHT)] + ([JParLight(*PAR)]
                                          if which == "soft" else [])
        out[which] = build_scene_arrays(load_mesh(path), spheres, lights)
    return out


def _jax_step(js, which, mesh, side):
    o, d, target = _rays(side)
    jmesh = jshard.make_mesh(("rays", "prims"), mesh,
                             devices=jax.devices()[:mesh[0] * mesh[1]])
    loss, new = jshard.train_step_sharded(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(target),
        cge_tpu.Features(**FEATURES[which]),
        cge_tpu.RenderParams(**PARAMS.get(which, {})), jmesh, lr=LR,
        seed=0)
    return float(loss), {k: np.asarray(getattr(new, k))
                         for k in ct.DIFF_FIELDS}


def _name(which, mesh, side=12):
    return f"{which}_{mesh[0]}x{mesh[1]}" + ("" if side == 12 else
                                             f"_{side}")


@pytest.fixture(scope="module")
def results(scenes, tmp_path_factory):
    """The port's steps in a 2-rank and a 4-rank gloo world and JAX's
    three sharded steps here, side by side."""
    tmp = str(tmp_path_factory.mktemp("train_ranks"))
    paths = {}
    for which, js in scenes.items():
        paths[which] = os.path.join(tmp, f"{which}.npz")
        np.savez(paths[which], all_opaque=js.all_opaque,
                 all_diffuse=js.all_diffuse,
                 **{k: np.asarray(getattr(js, k)) for k in TENSOR_FIELDS})
    rays = {}
    for side in (11, 12):
        for k, v in zip(("o", "d", "target"), _rays(side)):
            rays[f"{side}/{k}"] = v
    jobs = {2: [], 4: []}
    cases = [(w, m, 12) for w in FEATURES for m in MESHES]
    cases.append(("hard", (2, 1), 11))
    for which, mesh, side in cases:
        jobs[mesh[0] * mesh[1]].append(dict(
            kind="train", name=_name(which, mesh, side), scene=which,
            mesh=mesh, rays=str(side), features=FEATURES[which],
            params=PARAMS.get(which, {}), lr=LR, seed=0))
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        ranks = run_worlds(ex, tmp, paths, rays, jobs)
        ref = {_name(w, m, s): ex.submit(_jax_step, scenes[w], w, m, s)
               for w, m, s in JAX_CASES}
        return ranks(), {k: v.result() for k, v in ref.items()}


def _single(js, which, side=12):
    ps = _port(js)
    o, d, target = (torch.from_numpy(x) for x in _rays(side))
    loss, grads = ct.loss_and_grads(ps, o, d, target,
                                    ct.Features(**FEATURES[which]),
                                    ct.RenderParams(**PARAMS.get(which, {})))
    return ps, float(loss), {k: g.numpy() for k, g in grads.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("which", list(FEATURES))
def test_sharded_step_matches_single_device(scenes, results, which, mesh):
    ranks = results[0]
    name = _name(which, mesh)
    ps, loss, grads = _single(scenes[which], which)
    for key in ("loss", "grad_loss"):
        np.testing.assert_allclose(float(ranks[f"{name}/{key}"]), loss,
                                   rtol=1e-6)
    moved = []
    for k in ct.DIFF_FIELDS:
        g = ranks[f"{name}/grad/{k}"]
        new = ranks[f"{name}/new/{k}"]
        old = getattr(ps, k).numpy()
        assert np.isfinite(g).all() and np.isfinite(new).all(), k
        norm = float(np.linalg.norm(grads[k]))
        assert float(np.linalg.norm(g - grads[k])) <= 1e-4 * norm, k
        # the new leaves are sgd_step's of the sharded gradients
        np.testing.assert_array_equal(new, old - np.float32(LR) * g,
                                      err_msg=k)
        if not np.array_equal(new, old):
            moved.append(k)
    assert {"mat_kd", "point_pos", "sph_center"} <= set(moved)
    if which == "transrec":
        assert "mat_transparency" in moved
    # sgd_step recomputed the host flags from the stepped materials
    mat_ks = ranks[f"{name}/new/mat_ks"]
    tr = ranks[f"{name}/new/mat_transparency"]
    assert list(ranks[f"{name}/flags"]) == [bool((tr == 1).all()),
                                            bool((mat_ks == 0).all())]


def test_pad_rays_count_in_the_loss(scenes, results):
    """121 rays over 2 shards: one zero pad ray (radiance 0, target 0)
    joins the second shard's mean, so the loss is the single-device loss
    times 121 / 122, as in JAX."""
    ranks = results[0]
    _, loss, _ = _single(scenes["hard"], "hard", side=11)
    np.testing.assert_allclose(float(ranks["hard_2x1_11/loss"]),
                               loss * 121 / 122, rtol=1e-6)


@pytest.mark.parametrize("which,mesh,side", JAX_CASES)
def test_sharded_step_matches_jax(scenes, results, which, mesh, side):
    ranks, jref = results
    name = _name(which, mesh, side)
    jloss, jnew = jref[name]
    np.testing.assert_allclose(float(ranks[f"{name}/loss"]), jloss,
                               rtol=LOSS_RTOL.get(which, 1e-5))
    js = scenes[which]
    for k in ct.DIFF_FIELDS:
        old = np.asarray(getattr(js, k)).astype(np.float64)
        got, want = ranks[f"{name}/new/{k}"], jnew[k]
        assert np.isfinite(got).all() and np.isfinite(want).all(), k
        g = (old - want) / LR
        tol = (LR * (2e-3 * np.abs(g) + 1e-4 * np.abs(g).max())
               + 2 * np.spacing(np.abs(want).astype(np.float32)))
        assert (np.abs(got - want.astype(np.float64)) <= tol).all(), k
