"""The rank processes of tests/test_torch_sharding*.py.

Run as `python tests/torch_sharding_ranks.py SPEC.json OUT.npz` in every
rank of a gloo world on the CPU (cge_tpu_torch.parallel.launch.run_ranks
sets the env:// rendezvous). SPEC names the scenes (numpy leaves of the
JAX package's scenes, carried across with cge_tpu_torch.interop), the ray
batches and the jobs; every rank runs every job, and rank 0 writes the
results to OUT. `run_worlds` starts such worlds from a test. Imports
torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import cge_tpu_torch as ct  # noqa: E402
from cge_tpu_torch import parallel  # noqa: E402
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy  # noqa: E402
from cge_tpu_torch.ops import intersect  # noqa: E402
from cge_tpu_torch.parallel import comm  # noqa: E402
from cge_tpu_torch.parallel.launch import run_ranks  # noqa: E402


def load_scene(path):
    z = np.load(path)
    return scene_from_numpy({k: z[k] for k in TENSOR_FIELDS},
                            all_opaque=bool(z["all_opaque"]),
                            all_diffuse=bool(z["all_diffuse"]), device="cpu")


def mesh_of(job):
    return parallel.make_mesh(("rays", "prims"), tuple(job["mesh"]),
                              device_type="cpu")


def render(job, scenes, rays):
    img = parallel.render_image_sharded(
        scenes[job["scene"]], ct.Camera(), ct.Features(**job["features"]),
        ct.RenderParams(**job.get("params", {})), job["width"],
        job["height"], mesh_of(job), seed=job.get("seed", 0))
    return {"": img.numpy()}


def sweep(job, scenes, rays):
    """closest_hit with the triangles sharded over 'prims' (accel: the
    cluster sweep, packed in job["layout"]; else K3's twin)."""
    scene = scenes[job["scene"]]
    o, d, tmax = (torch.from_numpy(rays[f"{job['rays']}/{k}"])
                  for k in ("o", "d", "tmax"))
    accel = (intersect.build_accel(scene, job["layout"]) if job["accel"]
             else None)
    mesh = mesh_of(job)
    with comm.bind_mesh(mesh):
        ids = intersect.closest_hit(scene, o, d, tmax, accel,
                                    prims_axis="prims", perm_ids=True)
    return {"hit": ids.hit.numpy(), "t": ids.t.numpy(),
            "is_sphere": ids.is_sphere.numpy(), "prim": ids.prim.numpy()}


def raises(job, scenes, rays):
    """The ValueErrors of a prims_axis that does not fit the bound mesh."""
    scene = scenes[job["scene"]]
    mesh = mesh_of(job)
    out = {}
    for name, params in (("size", dict(prims_axis="prims",
                                       prims_axis_size=4)),
                         ("name", dict(prims_axis="tris",
                                       prims_axis_size=2))):
        with comm.bind_mesh(mesh):
            try:
                ct.render_image(scene, ct.Camera(), ct.Features(),
                                ct.RenderParams(**params), 8, 8)
                out[name] = np.array("")
            except ValueError as e:
                out[name] = np.array(str(e))
    return out


def train(job, scenes, rays):
    """train_step_sharded's loss and new leaves, and
    loss_and_grads_sharded's gradients."""
    scene = scenes[job["scene"]]
    o, d, target = (torch.from_numpy(rays[f"{job['rays']}/{k}"])
                    for k in ("o", "d", "target"))
    feats = ct.Features(**job["features"])
    params = ct.RenderParams(**job.get("params", {}))
    mesh = mesh_of(job)
    loss, new = parallel.train_step_sharded(scene, o, d, target, feats,
                                            params, mesh, lr=job["lr"],
                                            seed=job.get("seed", 0))
    gloss, grads = parallel.loss_and_grads_sharded(
        scene, o, d, target, feats, params, mesh, seed=job.get("seed", 0))
    out = {"loss": loss.numpy(), "grad_loss": gloss.numpy(),
           "flags": np.array([new.all_opaque, new.all_diffuse])}
    for k in ct.DIFF_FIELDS:
        out[f"new/{k}"] = getattr(new, k).numpy()
        out[f"grad/{k}"] = grads[k].numpy()
    return out


def run_worlds(ex, tmp, scenes, rays, worlds):
    """Submit the rank worlds of a test module to the executor ex, one per
    world size (world size -> jobs), each running this file over `scenes`
    (name -> npz path) and `rays` (name -> array); returns a function that
    waits for them and merges their results."""
    np.savez(os.path.join(tmp, "rays.npz"), **rays)

    def one(world, jobs):
        spec = os.path.join(tmp, f"spec{world}.json")
        out = os.path.join(tmp, f"out{world}.npz")
        with open(spec, "w") as f:
            json.dump({"scenes": scenes, "jobs": jobs,
                       "rays": os.path.join(tmp, "rays.npz")}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, env.get("PYTHONPATH", "")])
        run_ranks([sys.executable, os.path.abspath(__file__), spec, out],
                  world, 600, env=env)
        return dict(np.load(out))

    futures = [ex.submit(one, w, jobs) for w, jobs in worlds.items()]

    def merged():
        out = {}
        for fut in futures:
            out.update(fut.result())
        return out
    return merged


JOBS = {"render": render, "sweep": sweep, "raises": raises, "train": train}


def main(spec_path, out_path):
    torch.set_num_threads(1)
    parallel.init_distributed("gloo", init_method="env://")
    with open(spec_path) as f:
        spec = json.load(f)
    scenes = {k: load_scene(p) for k, p in spec["scenes"].items()}
    rays = np.load(spec["rays"]) if spec.get("rays") else {}
    out = {}
    for job in spec["jobs"]:
        for k, v in JOBS[job["kind"]](job, scenes, rays).items():
            out[f"{job['name']}/{k}" if k else job["name"]] = v
    out["collectives"] = np.array([comm.COLLECTIVES["calls"],
                                   comm.COLLECTIVES["bytes"]])
    if torch.distributed.get_rank() == 0:
        np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
