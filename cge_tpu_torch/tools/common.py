"""What the tuning tools and the smoke test share: the device, the
stand-in scenes (also textured), the tile-swizzled primary rays and the
device timer."""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np
import torch

from cge_tpu_torch.camera import Camera, pixel_grid
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.render.renderer import _swizzle_rows
from cge_tpu_torch.scene.scene import PointLight, load_scene_from_file

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
# the stand-in at teapot size: 2 * 40 * 192 = 15,360 triangles (the
# reference teapot, which needs the reference data directory, has 15,704)
TEAPOT_GRID = (41, 192)
# the full dragon stand-in: 801 x 384 grid, 614,400 triangles
DRAGON_GRID = (801, 384)


def add_device_args(ap, res: int = 512) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, timed) or cpu (the plain "
                         "twins, no times)")
    ap.add_argument("--res", type=int, default=res,
                    help="primary rays: res x res, a multiple of 32")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per configuration")


def device_from(name: str) -> torch.device:
    """The device to run on; a CUDA request without a card fails."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the "
                         "plain twins (no times)")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as every kept number needs."""
    if dev.type != "cuda":
        return "device: cpu (plain twins; device times not measured)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return (f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: "
            f"{lines[0] if lines else smi.stderr.strip()}")


def standin_scene(grid, dev: torch.device):
    """The dragon stand-in (tools/make_large_asset.py) at `grid` = (rings,
    segments) with one point light, written to a temporary OBJ and
    loaded on dev."""
    from tools.make_large_asset import write_obj

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dragon.obj")
        write_obj(path, *grid)
        return load_scene_from_file(path, [PointLight(*LIGHT)], device=dev)


def write_textured_obj(path: str, rings: int, segments: int,
                       tex_hw=(64, 96), seed: int = 0) -> str:
    """The stand-in's OBJ and MTL at (rings, segments), its body material
    textured through `map_Kd` with a seeded random PNG of tex_hw = (height,
    width), written by the port's write_png with every row filter; the
    belly stays untextured. Non-square, so a swapped height and width
    shows. Returns the PNG's path."""
    from cge_tpu_torch.scene.image_io import write_png
    from tools.make_large_asset import write_obj

    write_obj(path, rings, segments)
    base = os.path.splitext(path)[0]
    png = base + "_kd.png"
    texels = np.random.default_rng(seed).integers(
        0, 256, (*tex_hw, 3), dtype=np.uint8)
    write_png(png, texels, filters=(0, 1, 2, 3, 4))
    with open(base + ".mtl") as f:
        mtl = f.read()
    body = "newmtl dragonBody\n"
    with open(base + ".mtl", "w") as f:
        f.write(mtl.replace(body, body + f"map_Kd {os.path.basename(png)}\n"))
    return png


# the stand-in's material variants (write_variant_obj): each MTL statement
# rewritten, per material name ("" for both)
MATERIAL_VARIANTS = {
    # the body seen through (d 0.45), its Ks kept, so the TRANS+REC tree
    # branches
    "glass": {"dragonBody": {"d": "0.45"}},
    # bench.py's transrec shape (bench.py:224-227): Ks 0 everywhere and
    # d 0.45, the all-diffuse collapse of the tree
    "diffuse_glass": {"": {"Ks": "0 0 0", "d": "0.45"}},
    # glossy as written, with the belly at Ns 0: both the cone and the plain
    # mirror branch run
    "glossy": {"dragonBelly": {"Ns": "0"}},
}


def write_variant_obj(path: str, rings: int, segments: int,
                      variant: str) -> None:
    """The stand-in's OBJ and MTL at (rings, segments) with the material
    statements of MATERIAL_VARIANTS[variant] rewritten."""
    from tools.make_large_asset import write_obj

    write_obj(path, rings, segments)
    mtl = os.path.splitext(path)[0] + ".mtl"
    edits = MATERIAL_VARIANTS[variant]
    out, name = [], None
    with open(mtl) as f:
        for line in f.read().splitlines():
            key, _, _ = line.partition(" ")
            if key == "newmtl":
                name = line.split()[1]
            for scope in ("", name):
                if key in edits.get(scope, {}):
                    line = f"{key} {edits[scope][key]}"
            out.append(line)
    with open(mtl, "w") as f:
        f.write("\n".join(out) + "\n")


def primary_rays(res: int, dev: torch.device):
    """res x res pinhole rays in 32x16 screen-tile order: (o, d) [res^2, 3]."""
    grid = _swizzle_rows(pixel_grid(res, res, dev).reshape(-1, 2), res, res)
    return Camera().generate_rays(grid)


def walk_call(o, d, tmax, aabbs, tiles, layout: str, *,
              br: int = cs.DEFAULT_BR, sc_n: int | None = None,
              exact_keys: bool = True, **mode):
    """A call of K2 alone on one sweep's inputs, packed, keyed and sorted
    once here, so its time leaves out the key pass and the sort. mode:
    any_hit, shared_origin, refine_members, mxu."""
    inp = cs.sweep_setup(o, d, tmax, aabbs, tiles, layout, br, sc_n)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes, exact_keys)
    return lambda: cs.cluster_walk(order, skeys, inp.rays, inp.tiles,
                                   layout=layout, sc_n=inp.sc_n,
                                   aabbs=inp.aabbs, **mode)


# device cycles the stream sleeps before a timed run (~10 ms), so the host
# has enqueued the calls when the device starts them
SLEEP_CYCLES = 20_000_000


def device_ms(fn, dev: torch.device, reps: int = 5) -> float | None:
    """Mean device ms per call by CUDA events after one warm-up call; None
    on the CPU, where no device time exists. The stream sleeps first, so a
    call whose host side is slower than its kernels (a short K4 call) is
    timed on the device, not at the host's pace; a call that waits for the
    device inside (a render's per-level sync) is timed end to end."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fmt_ms(ms: float | None) -> str:
    return "ms not measured" if ms is None else f"{ms:.4f} ms"
