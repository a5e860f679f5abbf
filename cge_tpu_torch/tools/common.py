"""What the tuning tools share: the device, the stand-in scenes, the
tile-swizzled primary rays and the device timer."""

from __future__ import annotations

import os
import subprocess
import tempfile

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
