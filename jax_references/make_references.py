"""Makes the stored JAX references of the port's benchmark's sampled and
training cells (bench_torch/references/<cell>.npz) on the CPU, through the
JAX package (cge_tpu). It imports JAX, so it lives apart from the
benchmark (bench_torch/), which reads its files and never imports it.

- soft512: JAX's render_image_u8 frame at the cell's sample key;
- train128: JAX's loss and its gradient of every DIFF_FIELDS leaf, for
  the cell's target (the frame of mat_kd x 0.8 and point_pos + 0.1,
  traced by JAX under key 0) over the cell's camera rays, evaluated op by
  op (jax.disable_jit()), and the step of every leaf that JAX's sgd_step
  takes on those gradients (mat_kd's and point_pos's, the others 0) at
  the cell's rate: the stepped leaf less the leaf. Compiled, XLA:CPU fuses the step and contracts
  its products into FMAs; on this scene that rounding parts a few
  grazing mirror bounces from the program as written (12 of 16,384 rays,
  e.g. ray 8112's radiance 1.118 against 0.366), and those rays carry
  most of the vertex gradient. Op by op, each of JAX's operations rounds
  once, as the port's do (ops/fp32.py).

The scenes are the cells' stand-in OBJs, loaded by cge_tpu's own loader.
Each file records the commit, the command and the cell it was made from;
bench_torch/check.py refuses a file made for another cell definition.

--tail DIR reads a frame cell's card frame and reference as
bench_torch/control.py --save-frames writes them (<cell>_port.npy,
<cell>_reference.npy) and asks where the pixels that part by more than
one level come from: JAX's radiance of just those pixels' camera rays,
jitted and op by op (its XLA sweep), and op by op through its Pallas
cluster kernels in interpret mode (the cell's own path, accel cells
only), and the port's CPU twins at the cell's extra_transparency_unroll
and at twice it; each beside the card's and the reference's u8 pixels.

--tree-step runs the JAX package's train_step_sharded once on the
TRANS+REC tree set of tests/test_torch_sharding_train.py (the 9x8 glass
stand-in, ray_depth 3, 12x12 rays, lr 0.1, seed 0) at mesh (rays, prims) =
(2, 1) on 8 virtual CPU devices, and stores its loss, the gradient of
every DIFF_FIELDS leaf (read as the step multiplies it by the rate) and
the new leaves in tests/torch_tree_step_jax.npz, with a hash of the
scene's leaves and the rays, the command, the commit and the JAX version.
Its compile takes about 200 s on a CPU; the test holds the port's 2-rank
tree step to the file without compiling JAX.

    JAX_PLATFORMS=cpu python3 jax_references/make_references.py  # both
    JAX_PLATFORMS=cpu python3 jax_references/make_references.py soft512
    JAX_PLATFORMS=cpu python3 jax_references/make_references.py \
        --tail frames --cell transrec512
    JAX_PLATFORMS=cpu python3 jax_references/make_references.py --tree-step
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

if "--tree-step" in sys.argv:
    # the sharded step's mesh: tests/conftest.py's virtual CPU devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import cge_tpu  # noqa: E402
from bench_torch import cells as bc  # noqa: E402
from bench_torch.check import REPO, cell_record, reference_path  # noqa: E402
from cge_tpu.camera import pixel_grid  # noqa: E402
from cge_tpu.diff import gradients as jgrad  # noqa: E402
from cge_tpu.render.wavefront import trace  # noqa: E402
from cge_tpu.scene.scene import (ParallelogramLight, PointLight,  # noqa: E402
                                 load_scene_from_file)

STORED = ("soft512", "train128")
TREE_STEP = os.path.join(REPO, "tests", "torch_tree_step_jax.npz")
TREE_COMMAND = ("JAX_PLATFORMS=cpu python3 jax_references/make_references.py "
                "--tree-step")


def jax_scene(cell: bc.Cell, obj: str):
    if cell.light == "parallelogram":
        return load_scene_from_file(obj, [ParallelogramLight(*bc.PAR_LIGHT)])
    return load_scene_from_file(obj, [PointLight(*bc.POINT_LIGHT)])


def jax_frame(cell: bc.Cell, obj: str) -> np.ndarray:
    """JAX's render_image_u8 of the cell: [side, side, 3] u8."""
    scene = jax_scene(cell, obj)
    return np.asarray(cge_tpu.render_image_u8(
        scene, cge_tpu.Camera(), cge_tpu.Features(**cell.features),
        cge_tpu.RenderParams(**cell.params), cell.side, cell.side,
        cell.seed))


@jax.disable_jit()
def jax_train(cell: bc.Cell, obj: str) -> dict:
    """JAX's loss, gradients and steps of the cell's train step, op by
    op: {"loss": f32, "grad_<leaf>": array, "step_<leaf>": array} for
    every DIFF_FIELDS leaf; the step is sgd_step's on the gradients of
    TRAIN_LEAVES (the others' are zero) at TRAIN_LR."""
    scene = jax_scene(cell, obj)
    feats = cge_tpu.Features(**cell.features)
    params = cge_tpu.RenderParams(**cell.params)
    o, d = cge_tpu.Camera().generate_rays(
        pixel_grid(cell.side, cell.side).reshape(-1, 2))
    leaves = jgrad.scene_params(scene)
    moved = jgrad.with_params(scene, {
        **leaves, "mat_kd": leaves["mat_kd"] * bc.TRAIN_KD_SCALE,
        "point_pos": leaves["point_pos"] + bc.TRAIN_LIGHT_SHIFT})
    target = jnp.nan_to_num(trace(moved, o, d, feats, params,
                                  jax.random.PRNGKey(0)))
    loss, grads = jax.value_and_grad(jgrad.render_loss)(
        leaves, scene, o, d, target, feats, params,
        jax.random.PRNGKey(cell.seed))
    stepped = jgrad.scene_params(jgrad.sgd_step(scene, {
        k: g if k in bc.TRAIN_LEAVES else jnp.zeros_like(g)
        for k, g in grads.items()}, bc.TRAIN_LR))
    out = {"loss": np.float32(loss)}
    out.update({f"grad_{k}": np.asarray(g) for k, g in grads.items()})
    out.update({f"step_{k}": np.asarray(stepped[k] - leaves[k])
                for k in grads})
    return out


def outputs(cell: bc.Cell, obj: str) -> dict:
    """The arrays stored for a cell."""
    if cell.train:
        return jax_train(cell, obj)
    return {"frame": jax_frame(cell, obj)}


def tail_pixels(cell: bc.Cell, obj: str, port: np.ndarray,
                reference: np.ndarray) -> dict:
    """The pixels where the card's u8 frame `port` parts from `reference`
    by more than CLOSE_LEVELS, each source's u8 radiance of their camera
    rays ([n, 3]) and its agreement with the card's and the reference's
    (within CLOSE_LEVELS, and equal)."""
    import torch

    import cge_tpu_torch as ct
    from bench_torch.check import CLOSE_LEVELS, to_u8
    from cge_tpu.ops import intersect
    from cge_tpu_torch.ops import rng
    from cge_tpu_torch.render import wavefront as twave

    side = cell.side
    diff = np.abs(port.astype(int) - reference.astype(int)).max(-1)
    rows, cols = np.nonzero(diff > CLOSE_LEVELS)
    idx = (side - 1 - rows) * side + cols      # the frame is flipped in y
    key = 3                                    # render_image's pinhole key
    scene = jax_scene(cell, obj)
    feats = cge_tpu.Features(**cell.features)
    params = cge_tpu.RenderParams(**cell.params)

    def jax_rays():
        o, d = cge_tpu.Camera().generate_rays(
            pixel_grid(side, side).reshape(-1, 2))
        return np.asarray(trace(scene, o[idx], d[idx], feats, params,
                                jax.random.fold_in(
                                    jax.random.PRNGKey(cell.seed), key)))

    got = {"jax_jit": jax_rays()}
    with jax.disable_jit():
        got["jax_op_by_op"] = jax_rays()
        if cell.features.get("enable_accel_structure"):
            intersect.FORCE_CLUSTER_INTERPRET = True
            try:
                got["jax_pallas_op_by_op"] = jax_rays()
            finally:
                intersect.FORCE_CLUSTER_INTERPRET = False
    tscene = bc.load(cell, obj, "cpu")
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(side, side, "cpu").reshape(-1, 2))
    it = torch.from_numpy(idx)
    unroll = ct.RenderParams(**cell.params).extra_transparency_unroll
    for u in (unroll, 2 * unroll):
        tparams = ct.RenderParams(**dict(cell.params,
                                         extra_transparency_unroll=u))
        with torch.no_grad():
            got[f"port_cpu_unroll{u}"] = twave.trace(
                tscene, o[it], d[it], ct.Features(**cell.features), tparams,
                rng.fold_in(rng.prng_key(cell.seed), key)).numpy()
    card, ref = port[rows, cols].astype(int), reference[rows, cols].astype(int)
    out = dict(pixels=int(rows.size), tail_pixels=int(
        (diff >= 13).sum()), sources={})
    for name, rad in got.items():
        u8 = to_u8(rad).astype(int)
        out["sources"][name] = dict(
            near_card=int((np.abs(u8 - card).max(-1) <= CLOSE_LEVELS).sum()),
            equal_card=int((u8 == card).all(-1).sum()),
            near_reference=int((np.abs(u8 - ref).max(-1)
                                <= CLOSE_LEVELS).sum()))
    return out


class _Rate:
    """A learning rate that keeps each gradient it multiplies:
    train_step_sharded steps every leaf as `v - lr * g` over the sorted
    keys of its parameter dict, so `lr * g` hands over the gradients."""

    def __init__(self, value: float):
        self.value = value
        self.grads = []

    def __rmul__(self, g):
        return self * g

    def __mul__(self, g):
        self.grads.append(np.asarray(g))
        return self.value * g


def tree_scene_and_rays(tmp: str):
    """The JAX scene and 12x12 rays of tests/test_torch_sharding_train.py's
    TRANS+REC set (its `scenes` fixture and `_rays(12)`)."""
    from cge_tpu.scene.mesh_io import Material, load_mesh
    from cge_tpu.scene.scene import SphereDef, build_scene_arrays
    from cge_tpu_torch.tools.common import write_variant_obj

    spheres = [SphereDef((0.0, 0.1, 0.0), 0.3,
                         Material(kd=np.float32([0.9, 0.3, 0.2]),
                                  ks=np.float32([0.4, 0.4, 0.4]),
                                  shininess=12.0)),
               SphereDef((0.55, 0.45, -0.7), 0.2,
                         Material(kd=np.float32([0.2, 0.3, 0.9])))]
    path = os.path.join(tmp, "dragon.obj")
    write_variant_obj(path, 9, 8, "glass")
    scene = build_scene_arrays(load_mesh(path), spheres, [PointLight(
        (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))])
    o, d = cge_tpu.Camera().generate_rays(pixel_grid(12, 12).reshape(-1, 2))
    target = np.random.default_rng(5).uniform(0.0, 0.5, (144, 3)).astype(
        np.float32)
    return scene, np.array(o), np.array(d), target


def tree_inputs_sha256(leaves: dict, o, d, target) -> str:
    """SHA-256 of the scene's TENSOR_FIELDS leaves (in that order) and the
    rays and target, as C-order bytes."""
    import hashlib

    from cge_tpu_torch.interop import TENSOR_FIELDS

    h = hashlib.sha256()
    for a in [leaves[k] for k in TENSOR_FIELDS] + [o, d, target]:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tree_step() -> dict:
    """JAX's train_step_sharded on the tree set at mesh (2, 1): loss, the
    gradients ("grad/<leaf>") and the new leaves ("new/<leaf>")."""
    from cge_tpu.diff.gradients import DIFF_FIELDS
    from cge_tpu.parallel import sharding as jshard
    from cge_tpu_torch.interop import TENSOR_FIELDS

    with tempfile.TemporaryDirectory() as tmp:
        scene, o, d, target = tree_scene_and_rays(tmp)
    mesh = jshard.make_mesh(("rays", "prims"), (2, 1),
                            devices=jax.devices()[:2])
    rate = _Rate(0.1)
    feats = cge_tpu.Features(
        enable_shading=True, enable_hard_shadow=True, enable_recursive=True,
        enable_transparency=True, enable_normal_interp=True)
    loss, new = jshard.train_step_sharded(
        scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(target), feats,
        cge_tpu.RenderParams(ray_depth=3, extra_transparency_unroll=2),
        mesh, lr=rate, seed=0)
    keys = sorted(DIFF_FIELDS)                 # jax.tree.map's dict order
    assert len(rate.grads) == len(keys), len(rate.grads)
    out = {"loss": np.float32(loss)}
    for k, g in zip(keys, rate.grads):
        assert g.shape == np.shape(getattr(scene, k)), k
        out[f"grad/{k}"] = g
        out[f"new/{k}"] = np.asarray(getattr(new, k))
    leaves = {k: np.asarray(getattr(scene, k)) for k in TENSOR_FIELDS}
    out["inputs_sha256"] = np.array(tree_inputs_sha256(leaves, o, d, target))
    return out


def _git(*args) -> str:
    return subprocess.run(["git", *args], cwd=REPO, capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*", choices=STORED,
                    help="the cells to make (both by default)")
    ap.add_argument("--tail", metavar="DIR", help="ask where a frame "
                    "cell's pixels that part from its reference come from "
                    "(control.py --save-frames DIR); makes no file")
    ap.add_argument("--cell", default="transrec512",
                    help="--tail's cell")
    ap.add_argument("--tree-step", action="store_true",
                    help="store JAX's sharded tree train step for "
                    "tests/test_torch_sharding_train.py; makes no other "
                    "file")
    args = ap.parse_args(argv)
    if args.tree_step:
        t0 = time.perf_counter()
        arrays = tree_step()
        meta = dict(command=TREE_COMMAND, commit=_git("rev-parse", "HEAD"),
                    cge_tpu_unchanged_from_commit=not _git(
                        "status", "--porcelain", "cge_tpu"),
                    jax=jax.__version__, mesh=[2, 1], lr=0.1, seed=0,
                    seconds=round(time.perf_counter() - t0, 1))
        np.savez_compressed(TREE_STEP, meta=json.dumps(meta), **arrays)
        print(f"tree step: loss {float(arrays['loss'])!r} -> "
              f"{os.path.relpath(TREE_STEP, REPO)} ({meta['seconds']} s)",
              flush=True)
        return 0
    if args.tail:
        cell = bc.BY_NAME[args.cell]
        with tempfile.TemporaryDirectory() as tmp:
            obj = bc.obj_path(cell, tmp)
            bc.write_scene(cell, obj)
            r = tail_pixels(cell, obj, *(
                np.load(os.path.join(args.tail, f"{cell.name}_{k}.npy"))
                for k in ("port", "reference")))
        print(f"{cell.name}: {r['pixels']} pixels part from the reference "
              f"by more than 1 level, {r['tail_pixels']} by 13 or more")
        for name, v in r["sources"].items():
            print(f"  {name}: within 1 level of the card's frame on "
                  f"{v['near_card']} (equal on {v['equal_card']}), of the "
                  f"reference on {v['near_reference']}")
        return 0
    commit = _git("rev-parse", "HEAD")
    jax_changed = _git("status", "--porcelain", "cge_tpu")
    for name in args.cells or STORED:
        cell = bc.BY_NAME[name]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            obj = bc.obj_path(cell, tmp)
            bc.write_scene(cell, obj)
            arrays = outputs(cell, obj)
        meta = dict(
            cell=cell_record(cell), commit=commit,
            cge_tpu_unchanged_from_commit=not jax_changed,
            command="JAX_PLATFORMS=cpu python3 "
                    "jax_references/make_references.py " + name,
            jax=jax.__version__, seconds=round(time.perf_counter() - t0, 1))
        os.makedirs(os.path.dirname(reference_path(cell)), exist_ok=True)
        np.savez_compressed(reference_path(cell), meta=json.dumps(meta),
                            **arrays)
        shapes = ", ".join(f"{k} {v.shape} {v.dtype}"
                           for k, v in arrays.items())
        print(f"{name}: {shapes} -> "
              f"{os.path.relpath(reference_path(cell), REPO)} "
              f"({meta['seconds']} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
