#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cge_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs a CUDA card, builds the port's kernels from csrc/ with nvcc, and
exits non-zero if any phase fails:

  1. the card's name and power limit, the kernel build, and K1's inner
     loops counted by instruction kind from the SASS
     (cge_tpu_torch/tools/sass_count.py);
  2. K1 and K2 against their plain PyTorch twins on the card, on the full
     614,400-triangle dragon stand-in (cge_tpu_torch/scene/standin.py),
     through cge_tpu_torch/tools/kernel_bench.py's rows: primary rays and a
     bounce-like batch (scattered directions, a dead third), in the walk's
     four modes (closest with a shared origin; closest with per-ray
     origins; any-hit shadow rays; 4 clusters per visit); K1's keys and
     K2's t, ids, visits and dense tiles bit for bit (torch.equal). Each
     kernel's time beside its twin's, its bound
     (cge_tpu_torch/tools/roofline.py) and its share of it, and beside K1
     the sort of its keys, the rest of the key pass;
  3. the main path: the dragon at 512x512 through render_image_u8 with
     shading, hard shadows, recursive mirrors, interpolated normals and the
     accel, with the launch counters showing it ran through both kernels,
     and its median frame time;
  4. correctness: the dragon at 256x256 against the compiled reference's
     golden image (tests/golden/images/dragon_scale_256.raw), and a small
     scene rendered with the kernels on the card against the twins on the
     CPU;
  5. the brute-force sweep (K3) against its twin on the card, on the
     15,360-triangle stand-in (teapot size), through kernel_bench's rows:
     primary rays, a bounce-like batch with a dead third and forward
     shadow rays, t and ids exactly, with its time, bound and share;
  6. the second path: the accel-off 512x512 render of that scene through
     render_image_u8 (K3 only, no K1 or K2 launch), its median frame time
     and peak memory, held against the accel-on render of the same scene;
  7. the third path: the differentiable train step (loss_and_grads and
     sgd_step) over 128x128 camera rays of that scene, its ms per step, and
     the same step on the card against the CPU twins for the small scene:
     the tables both build bit for bit, the hits of every sweep, the loss
     and the gradients, with the first ops at which the two runs part
     (cge_tpu_torch/tools/op_diff.py) printed where they disagree;
  8. K2's opt-in modes against their twins on the card: refine_members (in
     the split walk) on the dragon at 2 clusters per visit (field layout)
     and on the 15,360-triangle stand-in (triangle layout), closest and
     any-hit, bit for bit and against the walk without refine, with the
     dense tiles it skipped; the tensor-core mxu mode (in the cluster
     walk) on the stand-in through kernel_bench's mxu rows, against its
     twin and the default walk within kernel_bench.MXU_TOL, at 512 rays a
     block and on primary rays at 128 and 1024, and on a copy of the stack
     with exact-t ties and pad rows at all three (ids equal to the twin's
     on the tied clusters); the times of every mode and twin, and the mxu
     mode's ratio to the default walk;
  9. the fourth path, kernel tuning: each tool of cge_tpu_torch.tools at
     a quick size (kernel_bench with --shapes: K2 in every split shape,
     the mxu mode in both of its shapes, K3 under each split rule), then a
     512x512
     render of the stand-in with the accel,
     frustum keys for both sweeps and the coherence ray order for bounces
     and shadows, held against the default accel render;
 10. K4, the streaming probe, against its twin on the three tile layouts
     at the dragon's scale, with GB/s per layout;
 11. the fifth path, the sampling and image-space features: 512x512 frames
     of the 15,360-triangle stand-in through render_image_u8, each with
     its launches, median frame and peak memory, and the calls, device ms
     and kernels of its plain-op parts (threefry draws, texel lookups,
     bloom) read from torch.profiler's trace of its first frame: the
     stand-in textured through map_Kd by a 96x64 PNG (nearest, bilinear),
     soft shadows from a 5x5 parallelogram light (accel off: K3; accel on:
     K1 and K2) and from a 25-sample segment light, the headline frame
     without and with bloom, MSAA 3x3, DoF 5 and both (these three at
     256x256), one timed frame each; K3, and K1 and K2,
     on one full 1,638,400-ray shadow batch of the soft frames (recorded
     as the frame hands it over) and K1 and K2 on one of that size over
     the dragon's 4,800 clusters, each timed, with the key table's bytes,
     and held to the twins on blocks spread over the batch; the reader of
     the plain-op parts against torch.profiler's own parse on two 32x32
     frames; then the card's threefry draws against the CPU's bit for
     bit, and each feature set on the 41x32 stand-in at 32x32 on the card
     against the CPU twins under phase 4's rule;
 12. the sixth path, transparency shadows, the TRANS+REC tree, glossy and
     batched cameras: frames of the 15,360-triangle stand-in in its
     material variants (cge_tpu_torch/tools/common.py MATERIAL_VARIANTS)
     through render_image_u8, each with its launches, lit share, first
     frame, one timed frame, peak memory and rays per level: the
     tree with hard shadows (glass: the body at d 0.45) at 512x512 with
     the accel off (K3 only) and on (K1 and K2 only), its all-diffuse
     collapse (Ks 0, d 0.45) with the accel off, glossy (the belly at Ns
     0) at 256x256 in 16,384-ray chunks with 40 cone samples a
     reflection, off and on; K1, the sort and K2's closest-mode walk on
     the fullest forward transparency-shadow batch of the accel-on tree,
     timed and held to the twins on blocks spread over it; three headline
     cameras of the dragon through render_images_u8, equal to three
     render_image_u8 calls; each feature set on the 41x32 stand-in at
     32x32 on the card against the CPU twins under phase 4's rule;
 13. the seventh path, the CLI and config, the reference BVH, the debugger,
     the preview and the app: `python -m cge_tpu_torch.cli` on a config of
     the dragon (512x512, the headline features with the accel, three
     cameras, one point light) in a subprocess and cli.run in this process
     with the launch counters reset (K1 and K2 only), and the same on the
     15,360-triangle stand-in with the accel off (K3 only), every BMP equal
     byte for byte to write_bmp of render_images of the same cameras, with
     the CLI's "Rendering took" lines; two cameras of the 41x32 stand-in
     at 64x64 through the CLI on the card against the CPU twins; the
     reference BVH of the stand-in (median and SAH, build ms) and its
     parity traversal of 128x128 primary rays on the card against K3
     (hit masks equal, t within rtol 5e-6 / atol 1e-7, ids off exact-t
     ties) and the CPU run bit for bit, with its ms; debug_trace of a 4x4
     fan into the dragon with mirrors on against the CPU twins; the
     preview of the stand-in at 256x256 (the share of pixels whose
     triangle id the card and the CPU agree on, its ms), an AppState of
     the stand-in's OBJ on the card (a ray-traced frame through K1 and K2,
     a raster frame) served on a free port, its GET /api/frame PNG equal
     to state.frame(); utils.profiling.trace around one CLI frame naming
     K2's kernel, and a checkpoint round trip of scene_params on the card;
 14. the eighth path, multi-device on the one card
     (cge_tpu_torch.parallel) and the native host library: the library
     built anew with g++ and its flags (-Werror), one object a source in
     parallel (its seconds), the dragon's OBJ loaded
     natively and by the numpy twin (seconds, same sub-meshes), its native
     cluster perm and the stand-in's native reference BVH (median, SAH)
     against the numpy twins; then worlds of rank processes of this script
     (`--rank SPEC`, started by parallel.launch.run_ranks with a timeout):
     a world of one on NCCL (the headline dragon frame through make_mesh
     and render_image_sharded, bit for bit its eager bounces' frame and
     render_image's in the same process, K1 and K2 launched); two ranks
     on NCCL, which refuses two ranks on one card (its message printed);
     two ranks on gloo with CUDA tensors: the dragon frame at rays = 2
     (bit for bit) and at prims = 2
     (each rank's K1 and K2 on 2,400 of the 4,800 clusters; the image
     rule), the frame's primary rays through the prims-sharded sweep (hits
     and t equal to the single-device sweep, ids off exact-t ties), the
     same on the stand-in with the accel off (K3 on half the rows), and
     the train step at rays = 2 and prims = 2 against loss_and_grads
     (TRAIN_LOSS_REL, TRAIN_GRAD_REL); four ranks at rays x prims = 2 x 2,
     the stand-in at 256x256 with the accel under the image rule. Every
     rank's launches, frame ms, collectives' calls, bytes and ms, and each
     world's wall seconds are printed;
 15. the ninth path, the compiled intersection library's cases
     (tests/golden/golden_intersect.bin) and the per-op frame
     attribution: its 4,096 triangle cases through K3 (a one-row table a
     case) and through K1, the sort and K2 (a one-triangle cluster a case,
     all cases in one sweep, each ray block's keys masked to its own
     case's cluster) in both tile layouts, t and ids bit for bit the twins' on the card
     and >= 99.9% of decisions the library's; the primitives of
     ops/intersect.py on every case of the four kinds on the card against
     the CPU bit for bit; then cge_tpu_torch/tools/frame_profile.py on
     scale512 and brute512 (3 profiled frames each): the wall and
     device-op ms a frame, the device busy share, the top ops, and the
     profiler's count of K1 and K2 (K3) equal to their launch counters;
 16. the tenth path, the port's benchmark (bench_torch/, BENCHMARK.json):
     its five cells (scale512, soft512, transrec512, brute512, train128)
     once each through bench_torch/bench.py's run_cell, one timed call
     and one traced call each, every output held to its reference: the
     compiled reference renderer (tools/oracle/oracle) in the same run
     for scale512, transrec512 and brute512, the stored JAX references
     (bench_torch/references/) for soft512 and train128;
 17. the bounces as CUDA graph replays (cge_tpu_torch/render/graphs.py):
     the frames of scale512, brute512, soft512 and transrec512 at the
     cells' own scenes, features, params and sizes, then the stand-in
     textured (bilinear) and glossy256 with the accel, from one prepared
     context each, rendered with eager bounces and through the graphs
     (the capturing frame and the replayed ones), every graph frame equal
     to the eager frame bit for bit (NaN masks too) with the same
     launches; the graphs a row, the peak allocated and reserved memory
     of each, and host ms a frame timed in turns (eager, graphs, graphs,
     eager); then camera batches through render_images (camera i with
     seed + i) at scale512, transrec512 and soft512, eager and through the
     graphs, frames equal bit for bit, with the peak memory of each, the
     entries the graph cache holds (at most its MAX_ENTRIES), and no
     capture after the first camera (soft512's draws read their keys
     from the graph's inputs);
 18. textures without Pillow (the card's machine has none): (a) every
     fixture of tests/torch_textures/ (PNG at every depth, colour type and
     interlace, BMP of every kind the port reads, JPEG of every kind
     Pillow opens (baseline and progressive, every whole sampling, CMYK
     and YCCK, arithmetic coding, block smoothing and lossless, each
     kind's host ms summed up), TGA, PNM, GIF, PSD, TIFF of
     every mode, compression
     (JPEG, CCITT RLE, Group 3 and 4, LZMA and ZSTD among them, and YCbCr
     through libtiff's RGBA path), predictor and organisation, lossy,
     lossless and animated WebP, DDS
     of every pixel format Pillow reads, BC1 to BC7 among them;
     jax_references/make_textures.py) decoded through
     the port's load_image, its u8 pixels' SHA-256 equal to the
     manifest's (JAX's load_image through Pillow made them), each
     decode's host ms; (b) scale512's 614,400-triangle dragon stand-in
     with its body textured by the 1024x1024 progressive 4:2:0 JPEG
     (map_Kd), loaded by load_scene_from_file on the card, rendered at
     512x512 through render_image_u8 with scale512's features plus
     texture mapping and bilinear filtering and the accel: the first
     frame with eager bounces and the sort counted (K1, the sort and K2
     must run), the rest through the graphs, every frame equal bit for
     bit to the frame of the same scene textured by the 8-bit RGB PNG
     that the port writes from the decoded texels; the scene's load s and
     the frame ms; (c) the same dragon textured by the JPEG's 1024x1024
     texels written at run time by the small writers here in the four
     formats added since, each loaded by load_scene_from_file and rendered
     as in (b): TGA (24-bit run-length, literal packets across the rows),
     PNM (P6), PSD (RGB, PackBits) and GIF (the texels' 3-3-2 quantisation
     to 256 colours, LZW held at 9-bit codes by a clear code every 254);
     and TIFF, raw, PackBits, Deflate with predictor 2, LZW (literal
     codes held at 9 bits by a clear code every 253) and LZMA with
     predictor 2 (the standard library's lzma, which must import there),
     in strips of 16 rows; and the committed WebP files of those texels,
     the 1024x1024 lossy one at quality 90 and the lossless 256x256 crop
     of their corner, and the committed 1024x1024 JPEG-in-TIFF of them
     (YCbCr 2x2 at quality 85 in 256x256 tiles, its tables in
     JPEGTables), and the committed 256x256 crop of their corner as an
     arithmetic-coded progressive YCCK JPEG at 4:4:0 whose scans leave a
     coefficient unrefined (block smoothing); and DDS, uncompressed
     A8R8G8B8, DXT1 and BC7 mode 6
     (each 4x4 block's minimum and maximum as endpoints, each pixel the nearest
     of the block's colours); each file's texels equal to the JPEG's
     (GIF: to their quantisation; the crop: to the JPEG's corner; the
     lossy WebP, DXT1, BC7 and the JPEG crop: to what they decode to,
     which (a) holds
     to the manifest through the same decoders), each frame
     equal bit for bit to the frame textured by the PNG of the same
     texels ((b)'s where they are the JPEG's), K1 and K2 launched as
     often as in (b)'s first frame; each file's host decode ms, load s
     and frame ms, and the host decode ms of the texels as an 8-bit RGB
     PNG with every row Paeth-filtered. (a) also reads the fixtures of
     tests/torch_textures/j2k_chip/, pillow_tail/ (old-style JPEG and
     ThunderScan TIFFs, JPEG YCbCr in planes, CIE L*a*b* TIFF and PSD,
     JPEG 2000 Part 2 markers: each kind's host ms summed up) and
     tail_chip/; (c) also the committed files of tail_chip/: the texels'
     512x512 crop as a Deflate L*a*b* TIFF (through the port's LittleCMS
     transform), the texels as a lossy JP2 with Part 2 MCT, MCC and MCO
     markers and as an old-style JPEG TIFF (YCbCr 2x2, a
     JPEGInterchangeFormat header, 64-row strips), each against the PNG of
     what it decodes to. (a) also reads tests/torch_textures/x11_pnm/
     (Pillow's other PNM modes, XBM, XPM, and the damaged JPEG, PNG and
     old-style JPEG TIFF files the port once parted from Pillow on: each
     kind's host ms summed up); (c) also writes the texels as P0CMYK,
     PyRGBA and Pf (their red channel) PNM files and their crops as an
     XBM (thresholded), an XPM of their 3-3-2 colours and an RGB XPM of
     more than 256 colours (x11_writers). (a) also reads
     tests/torch_textures/legacy/ (GIMP brushes, FLI / FLC, Windows Paint,
     PhotoCD, PIXAR, XV thumbnails) and science/ (FITS, McIdas, SPIDER,
     IM, IM Tools, IPTC; the refused files of both must raise a ValueError
     naming the file); (c) also writes the texels as PIXAR, a GIMP brush,
     a 3-3-2 FLC and XV thumbnail and a Windows Paint crop
     (legacy_writers), as an RGB IM and their green as FITS, SPIDER,
     McIdas, IM Tools and raw IPTC files (science_writers), and reads the
     committed PhotoCD of legacy/ and IPTC stream of science/ (a grey JPEG
     crop in band 2 of RGB), each against the PNG of what it decodes to.
     Each frame of (c) is the first and one timed, and the PNG frame of a
     set of texels is rendered once.

On the card a bounce replays a CUDA graph (phases 3-10 and 14-17).
Phases 11-13 swap the trace's functions to record its batches and read
torch.profiler's spans inside a frame, which a replay does not call, so
they run with eager bounces (graphs._eager_bounces).

`python3 chip_smoke.py --cards N` (N even, on a machine with N cards) runs
only the multi-card counterpart of phase 14: NCCL, one rank a card, the
dragon frame at rays = N (every rank's frame bit for bit render_image's
on its card and its own frame with eager bounces) and at N/2 x 2, the prims sweep and the train step at N x 1
and N/2 x 2, each against the single-card path.

Each path is driven with the launch counters set to 0 just before it and
read just after; each phase's line ends with the host's CPU (model, or
its family and model numbers where the host hides the name; its clock)
and the seconds since the start.
A summary gives each kernel's time beside its earlier design's (PERF.md),
its bound, share and launches per frame. The line before the last is a
JSON object with one entry per kernel; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W = H = 512
GOLDEN = os.path.join(REPO, "tests", "golden", "images",
                      "dragon_scale_256.raw")
# bench.py's scale512 knobs: one cluster per visit, 16k-ray trace chunks
MAIN_PARAMS = dict(sweep_sc_n=1, sweep_anyhit_sc_n=1, trace_chunk=16384)
HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_accel_structure=True)
GOLDEN_FEATURES = dict(enable_shading=True, enable_hard_shadow=True,
                       enable_normal_interp=True, enable_accel_structure=True)
# the default accel-off feature set of the second and third paths
BRUTE = {k: v for k, v in HEADLINE.items() if k != "enable_accel_structure"}
# the stand-in at teapot size: 2 * 40 * 192 = 15,360 triangles (the
# reference teapot has 15,704, bench.py:6)
TEAPOT_GRID = (41, 192)
TRAIN_SIDE = 128
TRAIN_LR = 2.0
# the small train step, card against CPU twins: with the same tables and
# hits, the loss's mean and the gradients' sums (atomics in the gathers'
# backward) add in another order; measured 1.4e-7 and 8.8e-6 (PERF.md)
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL = 1e-4
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
SEED = 0
# the knobs of the tuning path's render: frustum keys and ray sorting
ALL_KNOBS = dict(sweep_exact_keys=False, sweep_anyhit_exact_keys=False,
                 sweep_sort_bounce=True, sweep_sort_shadow=True)
# each kernel's time in its earlier design, before K1, K2's default and
# refine walks and K3 were redesigned (PERF.md's kernel table; NVIDIA H100
# 80GB HBM3, 700 W): K1, K2, K3 on phase 2's and 5's primary batches,
# refine and mxu on phase 8's, K4 on the padded stack
EARLIER_MS = {"keys": 0.2069, "walk": 4.5493, "sweep": 0.8987,
          "walk_refine": 6.4224, "walk_mxu": 1.5974, "stream_probe": 0.1144}
# each tool of the tuning path at a quick size
TOOL_RUNS = (
    ("sweep_grid", ["--cs", "128", "--brs", "512", "--reps", "2"]),
    ("dragon_grid", ["--rings", "201", "--res", "256", "--sub", "512",
                     "--reps", "2"]),
    ("mxu_grid", ["all", "--res", "256", "--reps", "2"]),
    ("stream_layout", ["--clusters", "1200", "--reps", "3"]),
    ("kernel_bench", ["--shapes", "--dragon", "201", "96", "--standin",
                      "41", "48", "--rays", "4096", "--reps", "2"]),
)


START = time.perf_counter()


def host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo's first processor gives it: its
    model name (or, where the host hides it as "unknown", its vendor,
    family and model numbers and cache), the processors, and the first
    one's clock now."""
    info, count = {}, 0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                count += key == "processor"
                if count == 1:
                    info.setdefault(key, value.strip())
    except OSError:
        return "unknown CPU (no /proc/cpuinfo)"
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
                f", {info.get('cache size', '?')} cache")
    return f"{name}, {count} CPUs, {info.get('cpu MHz', '?')} MHz"


def log(msg: str) -> None:
    """Print a line; a phase's line (and the summary's) ends with the
    host's CPU model and clock and the seconds since the start."""
    if msg.startswith("["):
        msg = (f"{msg} [host {host_cpu()}; t = "
               f"{time.perf_counter() - START:.1f} s]")
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------

def _bound_line(bound, ms) -> str:
    return f"bound {bound[0]:.4f} ms ({bound[1]}) share {bound[0] / ms:.3f}"


def check_kernels(scene, ctx, device):
    """Phase 2: K1 and K2 against their twins on the main path's batches
    (kernel_bench.walk_rows): K1's keys and K2's t, ids, visits and dense
    tiles bit for bit (the kernels are built with --fmad=false and the
    twins run one rounding per op); each kernel's time beside its twin's
    and its bound, and K1's beside the sort of its keys."""
    from cge_tpu_torch.tools import kernel_bench

    # walk_rows raises unless both are bit-equal to their twins
    report = {"keys": {"err": 0.0}, "walk": {"err": 0.0}}
    for row in kernel_bench.walk_rows(scene, ctx.accel, device):
        first = row["name"] == "a_primary"
        log("  " + kernel_bench.walk_line(
            row, EARLIER_MS["walk"] if first else None))
        if first:
            report["keys"].update(ms=row["keys_ms"],
                                  plain_ms=row["keys_plain_ms"],
                                  bound=row["keys_bound"])
            report["walk"].update(ms=row["ms"], plain_ms=row["plain_ms"],
                                  bound=row["bound"])
    return report


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path, the golden, GPU against CPU
# ---------------------------------------------------------------------------

def golden_check(img, path=GOLDEN):
    """test_golden_images.py:200-205: >= 99.5% of pixels close, and the
    99.99th-percentile error below 0.05."""
    import numpy as np

    raw = np.fromfile(path, dtype=np.float32)
    w, h = raw[:2].view(np.int32)
    ref = raw[2:].reshape(int(h), int(w), 3)
    both = np.isfinite(ref) & np.isfinite(img)
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = float(close.all(axis=-1).mean())
    q = float(np.quantile(np.abs(np.where(both, img - ref, 0.0)), 0.9999))
    return frac, q


def small_scene_check(device, tmp):
    """The 41x32 dragon at 64x64 with the headline features: kernels on the
    card against the twins on the CPU, under the golden rules."""
    import numpy as np

    import cge_tpu_torch as ct
    from cge_tpu_torch.scene.standin import write_obj

    path = os.path.join(tmp, "dragon_small.obj")
    write_obj(path, 41, 32)
    light = [ct.PointLight(*LIGHT)]
    f = ct.Features(**HEADLINE)
    p = ct.RenderParams(trace_chunk=1024)
    imgs = []
    for dev in (device, "cpu"):
        s = ct.load_scene_from_file(path, light, device=dev)
        imgs.append(ct.render_image(s, ct.Camera(), f, p, 64, 64).cpu()
                    .numpy())
    gpu, cpu = imgs
    nan_agree = float((np.isnan(gpu) == np.isnan(cpu)).mean())
    both = np.isfinite(gpu) & np.isfinite(cpu)
    frac = float((np.isclose(gpu, cpu, rtol=1e-4, atol=2e-4)
                  | ~both).all(axis=-1).mean())
    return nan_agree, frac


# ---------------------------------------------------------------------------
# phases 5-7: K3, the accel-off render, the train step
# ---------------------------------------------------------------------------

def check_sweep(ctx, device):
    """Phase 5: K3 against its twin on the accel-off path's batches
    (kernel_bench.sweep_rows): t and ids exactly (--fmad=false and the same
    operation order), with its time, the twin's and its bound."""
    from cge_tpu_torch.tools import kernel_bench

    report = {"err": 0.0}
    for row in kernel_bench.sweep_rows(ctx.tri_table, device):
        first = row["name"] == "a_primary"
        log("  " + kernel_bench.sweep_line(
            row, EARLIER_MS["sweep"] if first else None))
        if first:
            report.update(ms=row["ms"], plain_ms=row["plain_ms"],
                          bound=row["bound"])
    return report


def _counters():
    from cge_tpu_torch.ops import cluster_sweep, stream_probe, sweep

    return (cluster_sweep.LAUNCHES, sweep.LAUNCHES, stream_probe.LAUNCHES)


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def compare_images(a, b):
    """(NaN-mask agreement, fraction of pixels close) under the image
    rules: rtol 1e-4, atol 2e-4 where both are finite."""
    import numpy as np

    nan_agree = float((np.isnan(a) == np.isnan(b)).mean())
    both = np.isfinite(a) & np.isfinite(b)
    frac = float((np.isclose(a, b, rtol=1e-4, atol=2e-4)
                  | ~both).all(axis=-1).mean())
    return nan_agree, frac


def brute_path(scene, ctx, device):
    """The accel-off 512x512 frame: launches, median of 5 frames, peak
    memory; then its image against the accel-on render of the scene."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct

    feats = ct.Features(**BRUTE)
    params = ct.RenderParams()
    reset_launches()
    t0 = time.perf_counter()
    img = ct.render_image_u8(scene, ct.Camera(), feats, params, W, H, ctx=ctx)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if img.shape != (H, W, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"image {tuple(img.shape)} {img.dtype}")
    lit = float((img.float().sum(-1) > 0).float().mean())
    if lit < 0.05:
        raise AssertionError(f"accel-off image is blank: {lit:.4f} lit")
    if launches["sweep"] <= 0:
        raise AssertionError("the accel-off path never launched K3")
    if launches["keys"] or launches["walk"]:
        raise AssertionError(f"the accel-off path launched K1/K2: {launches}")
    torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ct.render_image_u8(scene, ct.Camera(), feats, params, W, H, ctx=ctx)
        end.record()
        torch.cuda.synchronize()
        frames.append(start.elapsed_time(end))
    ms = float(np.median(frames))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[6] accel-off 512x512 ({int(scene.tri_mask.sum())} triangles): "
        f"launches {launches}, lit {lit:.3f}, first frame {first_s:.2f} s, "
        f"frames ms {[round(x, 2) for x in frames]}, median {ms:.2f} ms, "
        f"{W * H * 2 / ms / 1e3:.3f} Mrays/s, peak memory {peak:.0f} MiB")
    off = ct.render_image(scene, ct.Camera(), feats, params, W, H,
                          ctx=ctx).cpu().numpy()
    on = ct.render_image(scene, ct.Camera(), ct.Features(**HEADLINE),
                         params, W, H).cpu().numpy()
    nan_agree, frac = compare_images(off, on)
    log(f"    accel off vs on (same scene, card): NaN agree "
        f"{nan_agree:.5f}, {frac:.4%} pixels close")
    if nan_agree < 0.999 or frac < 0.995:
        raise AssertionError("accel-off and accel-on renders disagree")
    return launches


def camera_rays(side: int, device):
    import cge_tpu_torch as ct

    return ct.Camera().generate_rays(
        ct.camera.pixel_grid(side, side, device).reshape(-1, 2))


def train_path(scene, device):
    """loss_and_grads + sgd_step over TRAIN_SIDE^2 camera rays against a
    target rendered from perturbed mat_kd and point_pos, stepping those two
    leaves back (inverse rendering): launches, ms per step (median of 5),
    finite gradients, and a loss that falls."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.ops import rng
    from cge_tpu_torch.render.wavefront import trace

    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    o, d = camera_rays(TRAIN_SIDE, device)
    leaves = ct.scene_params(scene)
    perturbed = ct.with_params(scene, {
        **leaves, "mat_kd": leaves["mat_kd"] * 0.8,
        "point_pos": leaves["point_pos"] + 0.1})
    with torch.no_grad():
        target = torch.nan_to_num(trace(perturbed, o, d, feats, params,
                                        rng.prng_key(SEED)))
    def step(s):
        loss, grads = ct.loss_and_grads(s, o, d, target, feats, params)
        return loss, grads, ct.sgd_step(s, {
            k: g if k in ("mat_kd", "point_pos") else torch.zeros_like(g)
            for k, g in grads.items()}, TRAIN_LR)

    reset_launches()
    loss, grads, s = step(scene)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["sweep"] <= 0 or launches["keys"] or launches["walk"]:
        raise AssertionError(f"train step launches {launches}")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss or gradients: {bad}")
    losses, steps = [float(loss)], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, grads, s = step(s)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    ms = float(np.median(steps))
    log(f"[7] train step, {TRAIN_SIDE}x{TRAIN_SIDE} rays, "
        f"{int(scene.tri_mask.sum())} triangles: launches {launches}, "
        f"ms per step {[round(x, 2) for x in steps]}, median {ms:.2f} ms; "
        f"losses {[f'{x:.6g}' for x in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the train steps did not lower the loss")
    return ms


def table_report(card, cpu) -> list:
    """The tables the small train step reads, built on the card and on
    the CPU, compared bit for bit (NaN equal to NaN): (name, differing
    elements, those that differ only in the sign of a zero, max |card -
    CPU|) for the scene's leaves, K3's triangle table, the accel's boxes
    and tiles in both layouts and the attribute rows."""
    import torch

    from cge_tpu_torch.ops.intersect import build_accel
    from cge_tpu_torch.ops.sweep import pack_tri_table
    from cge_tpu_torch.render.wavefront import pack_attr_table
    from cge_tpu_torch.tools import op_diff

    def tables(s):
        out = {k: getattr(s, k) for k in ("vertices", "normals", "tris",
                                          "mat_kd", "mat_ks", "point_pos")}
        out["tri_table"] = pack_tri_table(s.vertices, s.tris, s.tri_mask)
        for layout in ("triangle", "field"):
            acc = build_accel(s, layout)
            out[f"aabbs ({layout})"] = acc.aabbs
            out[f"tiles ({layout})"] = acc.tiles
        out["attribute rows"] = pack_attr_table(s)
        return out

    a, b = tables(card), tables(cpu)
    rows = []
    for k in a:
        x, y = a[k].cpu(), b[k]
        differ = op_diff.bits_differ(x, y)
        zeros = differ & (x == y)                 # +0 against -0
        gap = (x.double() - y.double()).abs()[differ & ~zeros]
        gap = gap[torch.isfinite(gap)]
        rows.append((k, int(differ.sum()), int(zeros.sum()),
                     float(gap.max()) if gap.numel() else 0.0))
    return rows


def _show_partings(parts) -> str:
    return "; ".join(f"#{i} {name} ({n} elements, card/CPU {vals})"
                     for i, name, n, vals in parts) or "none"


def record_traces(card, cpu, o, d, feats, params) -> list:
    """The small train step's forward trace on the card and on the CPU
    twins, every op recorded (cge_tpu_torch/tools/op_diff.py; a sweep, a
    square root and a power each as one op): [card entries, CPU
    entries]."""
    import torch

    from cge_tpu_torch.ops import fp32, rng, sweep
    from cge_tpu_torch.render.wavefront import trace
    from cge_tpu_torch.tools import op_diff

    runs = []
    for s in (card, cpu):
        so, sd = o.to(s.vertices.device), d.to(s.vertices.device)
        with torch.no_grad(), op_diff.Recorder(
                pause=[(sweep, "closest_tris"), (fp32, "sqrt_rn"),
                       (fp32, "pow_f64")]) as rec:
            trace(s, so, sd, feats, params, rng.prng_key(SEED))
        runs.append(rec.entries)
    return runs


def sweep_ids_differ(a, b) -> tuple:
    """(rays whose K3 ids differ, per sweep call of the traces a and b;
    the first such ray or None)."""
    from cge_tpu_torch.tools import op_diff

    counts, ray = [], None
    for (_, ea), (_, eb) in zip(op_diff.named(a, "closest_tris"),
                                op_diff.named(b, "closest_tris")):
        differ = ea[1][1] != eb[1][1]
        counts.append(int(differ.sum()))
        if ray is None and differ.any():
            ray = int(differ.nonzero()[0, 0])
    return counts, ray


def log_partings(a, b, ray, rows: int) -> None:
    """The first ops at which the card's and the CPU's traces part, and
    those at which one ray whose ids differ parts."""
    from cge_tpu_torch.tools import op_diff

    log(f"    forward trace: {len(a)} / {len(b)} ops recorded (card / CPU); "
        f"first ops where they part: "
        f"{_show_partings(itertools.islice(op_diff.partings(a, b), 4))}")
    if ray is not None:
        rparts = op_diff.partings(a, b, row=ray, rows=rows)
        log(f"    ray {ray} (its ids differ): first ops where it parts: "
            f"{_show_partings(itertools.islice(rparts, 6))}")


def small_train_check(device, tmp):
    """The same step on the card and on the CPU twins for the 41x32
    stand-in at 64x64 rays: the tables both build are equal bit for bit (a
    zero's sign aside), no ray's K3 ids differ in any sweep of the forward
    trace, the loss agrees to TRAIN_LOSS_REL and each gradient to
    TRAIN_GRAD_REL of its norm. Where one fails, the tables that differ
    and the first ops at which the traces part are printed."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct

    path = os.path.join(tmp, "dragon_small.obj")
    if not os.path.exists(path):
        from cge_tpu_torch.scene.standin import write_obj
        write_obj(path, 41, 32)
    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    rng = np.random.default_rng(SEED)
    target = torch.from_numpy(
        rng.uniform(0.0, 0.5, (64 * 64, 3)).astype(np.float32))
    o, d = camera_rays(64, "cpu")      # both sides trace the same rays
    scenes = [ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)],
                                      device=dev)
              for dev in (device, torch.device("cpu"))]
    tables = table_report(*scenes)
    bad_tables = [row for row in tables if row[1] > row[2]]
    a, b = record_traces(*scenes, o, d, feats, params)
    counts, ray = sweep_ids_differ(a, b)
    out = []
    for s in scenes:
        dev = s.vertices.device
        loss, g = ct.loss_and_grads(s, o.to(dev), d.to(dev), target.to(dev),
                                    feats, params)
        out.append((float(loss), {k: v.cpu() for k, v in g.items()}))
    (gl, gg), (cl, cg) = out
    rel = {k: float((gg[k] - cg[k]).norm() / cg[k].norm())
           for k in cg if float(cg[k].norm()) > 0}
    worst = max(rel, key=rel.get)
    log(f"    small train step, card vs CPU twins: {len(tables)} tables, "
        f"{len(bad_tables)} differ; rays whose K3 ids differ, per sweep "
        f"call: {counts}; loss {gl:.8g} vs {cl:.8g}, worst gradient {worst} "
        f"at {rel[worst]:.3g} of its norm")
    if (bad_tables or any(counts) or abs(gl - cl) > TRAIN_LOSS_REL * abs(cl)
            or rel[worst] > TRAIN_GRAD_REL):
        for k, n, z, gap in bad_tables:
            log(f"    table {k}: {n} elements differ ({z} only in a zero's "
                f"sign), max |gap| {gap:.3g}")
        log_partings(a, b, ray, o.shape[0])
        raise AssertionError("card and CPU train steps disagree")


# ---------------------------------------------------------------------------
# phase 8: K2's opt-in modes against their twins
# ---------------------------------------------------------------------------

def _mode_batches(scene, accel, device):
    """(o, d, tmax, any-hit) of the primary, bounce-like and shadow batches
    of kernel_bench.walk_batches for this scene and accel."""
    from cge_tpu_torch.tools import kernel_bench

    batches = kernel_bench.walk_batches(scene, accel, device)
    return {k: (v[0], v[1], v[2], v[4]) for k, v in batches.items()
            if k in ("a_primary", "b_bounce", "c_shadow")}


def _walk_inputs(batch, accel, sc_n):
    from cge_tpu_torch.ops import cluster_sweep as cs

    o, d, tmax, any_hit = batch
    inp = cs.sweep_setup(o, d, tmax, accel.aabbs, accel.tiles, accel.layout,
                         cs.DEFAULT_BR, sc_n)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout=accel.layout, sc_n=inp.sc_n, any_hit=any_hit,
              aabbs=inp.aabbs)
    return (order, skeys, inp.rays, inp.tiles), kw


def _walk_bound(args, kw, out, **mode):
    from cge_tpu_torch.tools import roofline

    return roofline.walk_bound(args[0], args[2], args[3], out,
                               layout=kw["layout"], sc_n=kw["sc_n"],
                               any_hit=kw["any_hit"], **mode)


def check_refine(scene, accel, device, sc_n: int, label: str, stats):
    """refine_members on the card: t, ids, visits and dense tiles equal to
    the twin's bit for bit, and t, ids and visits equal to the default
    kernel's, which equals its own twin. Adds the tiles skipped to
    stats."""
    import torch

    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.tools import kernel_bench

    for name, batch in _mode_batches(scene, accel, device).items():
        args, kw = _walk_inputs(batch, accel, sc_n)
        base = cs.cluster_walk(*args, **kw)
        kernel_bench.check_equal(base, cs.cluster_walk_plain(*args, **kw),
                                 f"{label} {name}: K2")
        got = cs.cluster_walk(*args, refine_members=True, **kw)
        twin = cs.cluster_walk_plain(*args, refine_members=True, **kw)
        for what, a, b in zip(("t", "ids", "visits", "dense tiles"), got,
                              twin):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} {name}: refine {what} differ "
                                     f"from the twin")
        for what, a, b in zip(("t", "ids", "visits"), got, base):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} {name}: refine {what} differ "
                                     f"from the walk without refine")
        tiles = int(base[3].sum())
        kept = int(got[3].sum())
        if tiles != int(base[2].sum()) * kw["sc_n"]:
            raise AssertionError(f"{label} {name}: dense tiles != visits x "
                                 f"sc_n without refine")
        stats["skipped"] += tiles - kept
        t = dict(walk=cuda_ms(lambda: cs.cluster_walk(*args, **kw)),
                 refine=cuda_ms(lambda: cs.cluster_walk(
                     *args, refine_members=True, **kw)),
                 twin=cuda_ms(lambda: cs.cluster_walk_plain(
                     *args, refine_members=True, **kw), reps=1))
        bound = _walk_bound(args, kw, got, refine=True)
        first = label == "dragon" and name == "a_primary"
        log(f"  {label} sc_n={kw['sc_n']} {name}: blocks "
            f"{args[2].shape[0]} visits {int(base[2].sum())} dense tiles "
            f"{tiles} -> {kept} with refine | ms K2 {t['walk']:.4f} "
            f"({_bound_line(_walk_bound(args, kw, base), t['walk'])}) refine "
            f"{t['refine']:.4f} (twin {t['twin']:.3f}"
            f"{', earlier %s' % EARLIER_MS['walk_refine'] if first else ''}) "
            f"{_bound_line(bound, t['refine'])}")
        if first:
            stats.update(ms=t["refine"], plain_ms=t["twin"], bound=bound)


def check_mxu(tscene, device, stats):
    """The tensor-core mode on the stand-in through kernel_bench.mxu_rows:
    against its twin (torch.matmul, TF32 off) and the default walk within
    MXU_TOL on the primary, bounce-like and shadow batches, and against the
    twin at kernel_bench.MXU_CHECK_BRS rays a block and on a tied stack
    (kernel_bench.check_ties) on primary rays; its time, its ratio to the
    default walk's on the same batch, its bound."""
    from cge_tpu_torch.tools import kernel_bench

    for row in kernel_bench.mxu_rows(tscene, device):
        first = row["name"] == "a_primary"
        log("  " + kernel_bench.mxu_line(
            row, EARLIER_MS["walk_mxu"] if first else None))
        stats["err"] = max(stats["err"], row["err"])
        if first:
            stats.update(ms=row["ms"], plain_ms=row["plain_ms"],
                         bound=row["bound"])


def check_modes(scene, accel, tscene, device):
    """Phase 8: refine on the dragon (sc_n = 2, field layout) and the
    stand-in (sc_n = 1, triangle layout), mxu on the stand-in."""
    from cge_tpu_torch.ops.intersect import build_accel

    taccel = build_accel(tscene, "triangle")
    refine = {"err": 0.0, "skipped": 0}
    check_refine(scene, accel, device, 2, "dragon", refine)
    check_refine(tscene, taccel, device, 1, "stand-in", refine)
    if refine["skipped"] <= 0:
        raise AssertionError("refine_members skipped no dense tile")
    log(f"    refine: bit-equal everywhere, {refine['skipped']} dense tiles "
        f"skipped in all")
    mxu = {"err": 0.0}
    check_mxu(tscene, device, mxu)
    return {"refine": refine, "mxu": mxu}


# ---------------------------------------------------------------------------
# phases 9 and 10: the tuning path, K4
# ---------------------------------------------------------------------------

def tuning_path(tscene, device):
    """Each tool's main at a quick size with the counters read around the
    lot; then the stand-in's 512x512 accel render with every sweep knob of
    ALL_KNOBS against the default accel render. Returns the tools'
    launches."""
    import importlib

    import torch

    import cge_tpu_torch as ct

    log("[9] tuning path: cge_tpu_torch.tools at quick sizes")
    reset_launches()
    for name, argv in TOOL_RUNS:
        t0 = time.perf_counter()
        rc = importlib.import_module(f"cge_tpu_torch.tools.{name}").main(argv)
        log(f"    ({name} {' '.join(argv)}: exit {rc}, "
            f"{time.perf_counter() - t0:.1f} s)")
        if rc != 0:
            raise AssertionError(f"tool {name} exited {rc}")
    launches = read_launches()
    log(f"    tools' launches {launches}")
    for k in ("walk_refine", "walk_mxu", "stream_probe"):
        if launches[k] <= 0:
            raise AssertionError(f"the tuning path never launched {k}")

    feats = ct.Features(**HEADLINE)
    params = ct.RenderParams(**ALL_KNOBS)
    ctx = ct.prepare_render(tscene, feats, params)
    reset_launches()
    img = ct.render_image(tscene, ct.Camera(), feats, params, W, H, ctx=ctx)
    torch.cuda.synchronize()
    knobs = read_launches()
    if knobs["walk"] <= 0 or knobs["keys"] or knobs["sweep"]:
        raise AssertionError(f"the all-knobs render launched {knobs}")
    ms = cuda_ms(lambda: ct.render_image(tscene, ct.Camera(), feats, params,
                                         W, H, ctx=ctx), reps=3)
    base_params = ct.RenderParams()
    base_ctx = ct.prepare_render(tscene, feats, base_params)
    base = ct.render_image(tscene, ct.Camera(), feats, base_params, W, H,
                           ctx=base_ctx)
    base_ms = cuda_ms(lambda: ct.render_image(
        tscene, ct.Camera(), feats, base_params, W, H, ctx=base_ctx), reps=3)
    nan_agree, frac = compare_images(img.cpu().numpy(), base.cpu().numpy())
    log(f"    all-knobs render 512x512 ({int(tscene.tri_mask.sum())} "
        f"triangles, {ALL_KNOBS}): launches {knobs}, {ms:.2f} ms vs "
        f"{base_ms:.2f} ms default accel render; NaN agree {nan_agree:.5f}, "
        f"{frac:.4%} pixels close")
    if nan_agree < 0.999 or frac < 0.995:
        raise AssertionError("the all-knobs render disagrees with the default")
    return launches


def check_stream(device):
    """Phase 10: K4 against its twin on the three layouts at L = 4800,
    C = 128, within stream_layout's bound; GB/s per layout."""
    from cge_tpu_torch.ops import stream_probe
    from cge_tpu_torch.tools import common, roofline, stream_layout

    report = {"err": 0.0}
    log("[10] K4 stream_sum vs twin (L = 4800 clusters, C = 128)")
    for name, stack in stream_layout.make_stacks(4800, 128, device).items():
        m = stream_layout.measure(stack, device, reps=20)
        gb = stream_probe.stream_bytes(stack) / 1e9
        log(f"  {name}: {gb * 1e3:.1f} MB | warm {m['ms']:.4f} ms "
            f"{gb / (m['ms'] / 1e3):.1f} GB/s, cold {m['cold_ms']:.4f} ms "
            f"{gb / (m['cold_ms'] / 1e3):.1f} GB/s | twin {m['plain_ms']:.4f}"
            f" ms | max |K4 - twin| {m['err']:.3g} (bound {m['bound']:.3g})")
        if m["err"] > m["bound"]:
            raise AssertionError(f"{name}: K4 disagrees with its twin")
        report["err"] = max(report["err"], m["err"])
        if name.startswith("A"):
            n = stack.shape[0] // stream_probe.SC_N * stream_probe.SC_N
            lib_ms = common.device_ms(
                lambda: stack[:n].sum(dim=(0, 1)), device, reps=20)
            bound = roofline.stream_bound(
                stream_probe.stream_bytes(stack) // 4, stack.shape[2])
            log(f"    {_bound_line(bound, m['ms'])}; one torch.sum "
                f"{lib_ms:.4f} ms; earlier {EARLIER_MS['stream_probe']}")
            report.update(ms=m["ms"], plain_ms=m["plain_ms"], bound=bound,
                          library_ms=lib_ms)
    return report


# ---------------------------------------------------------------------------
# phase 11: texture, soft shadows, bloom, MSAA and DoF
# ---------------------------------------------------------------------------

# the soft lights near the point light: a parallelogram with four corner
# colours (bench.py's soft feature set samples it 5x5) and a segment
PAR_LIGHT = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4),
             (1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.2, 1.0),
             (1.0, 1.0, 0.2))
SEG_LIGHT = ((-1.4, 1.0, -0.8), (-0.6, 1.2, -1.4), (1.0, 0.6, 0.2),
             (0.2, 0.6, 1.0))
# bench.py's soft feature set, with interpolated normals: the stand-in's
# geometric normals face inward and shade it black
SOFT = dict(enable_shading=True, enable_soft_shadow=True,
            enable_normal_interp=True)
TEX_HW = (64, 96)               # (height, width): a swapped pair shows
# a soft512 frame's shadow batch: a 65,536-ray chunk's hits x 5 x 5 samples
SHADOW_BATCH = 65536 * 25
# the 512-ray blocks the twins check of a full shadow batch (slice_blocks)
SLICE_BLOCKS = 8
FIFTH_FRAMES = 1
FIFTH_SEED = 1
# the side of the card-against-CPU-twin frames of phases 11 and 12
SMALL_SIDE = 32
# the rows rendered at 256x256 rather than 512x512: the most primary rays
# a frame, and the profiled first frame's cost with them
FIFTH_SIDES = {"MSAA 3x3": 256, "DoF 5": 256, "MSAA 3x3 + DoF 5": 256}
# (label, scene, features) of each 512x512 frame; accel off must launch K3
# only, accel on K1 and K2 only; bloom's row is timed beside the same frame
# without it
FIFTH_ROWS = (
    ("texture nearest", "tex", dict(BRUTE, enable_texture_mapping=True)),
    ("texture bilinear", "tex", dict(
        BRUTE, enable_texture_mapping=True,
        enable_bilinear_texture_filtering=True)),
    ("soft512, accel off", "par", SOFT),
    ("soft512, accel on", "par", dict(SOFT, enable_accel_structure=True)),
    ("segment light", "seg", SOFT),
    ("headline (bloom's baseline)", "point", HEADLINE),
    ("bloom", "point", dict(HEADLINE, enable_bloom_effect=True)),
    ("MSAA 3x3", "point", dict(HEADLINE, enable_multiple_rays_per_pixel=True)),
    ("DoF 5", "point", dict(HEADLINE, enable_depth_of_field=True)),
    ("MSAA 3x3 + DoF 5", "point", dict(
        HEADLINE, enable_multiple_rays_per_pixel=True,
        enable_depth_of_field=True)),
)


def fifth_scenes(tmp, grid, device):
    """The stand-in at `grid` on `device` under each light set: textured
    with a point light, the parallelogram light, the segment light, the
    point light."""
    import cge_tpu_torch as ct
    from cge_tpu_torch.scene.scene import ParallelogramLight, SegmentLight
    from cge_tpu_torch.tools.common import write_textured_obj

    tag = "x".join(map(str, grid))
    tex = os.path.join(tmp, f"standin_tex_{tag}.obj")
    if not os.path.exists(tex):
        write_textured_obj(tex, *grid, tex_hw=TEX_HW, seed=SEED)
    plain = os.path.join(tmp, f"standin_{tag}.obj")
    if not os.path.exists(plain):
        from cge_tpu_torch.scene.standin import write_obj
        write_obj(plain, *grid)
    point = [ct.PointLight(*LIGHT)]
    return {"tex": ct.load_scene_from_file(tex, point, device=device),
            "par": ct.load_scene_from_file(
                plain, [ParallelogramLight(*PAR_LIGHT)], device=device),
            "seg": ct.load_scene_from_file(
                plain, [SegmentLight(*SEG_LIGHT)], device=device),
            "point": ct.load_scene_from_file(plain, point, device=device)}


def fifth_frame(label, scene, feats, labels):
    """One row of phase 11 at 512x512 (FIFTH_SIDES: 256x256): the first
    frame with the counters reset around it, under torch.profiler for its
    plain-op parts (frame_profile's reader; a part that ran with no kernel
    fails), then FIFTH_FRAMES timed frames (CUDA events) with peak memory.
    Returns the row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cge_tpu_torch as ct
    from cge_tpu_torch.tools import frame_profile

    f, params = ct.Features(**feats), ct.RenderParams()
    side = FIFTH_SIDES.get(label, W)
    ctx = ct.prepare_render(scene, f, params)
    reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        img = ct.render_image_u8(scene, ct.Camera(), f, params, side, side,
                                 FIFTH_SEED, ctx=ctx)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    plain = frame_profile.plain_ops(frame_profile.read_events(prof), labels)
    del prof
    missing = [k for k, (calls, _, n) in plain.items() if calls and not n]
    if missing:
        raise AssertionError(f"torch.profiler holds no kernel of {missing}")
    if img.shape != (side, side, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"{label}: image {tuple(img.shape)} {img.dtype}")
    lit = float((img.float().sum(-1) > 0).float().mean())
    if lit < 0.05:
        raise AssertionError(f"{label}: image is blank ({lit:.4f} lit)")
    want = ("keys", "walk") if feats.get("enable_accel_structure") else (
        "sweep",)
    other = {"keys", "walk", "sweep"} - set(want)
    if (any(launches[k] <= 0 for k in want)
            or any(launches[k] for k in other)):
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(FIFTH_FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ct.render_image_u8(scene, ct.Camera(), f, params, side, side,
                           FIFTH_SEED, ctx=ctx)
        end.record()
        torch.cuda.synchronize()
        frames.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = float(np.median(frames))
    n_px = side * side
    spp = (params.rays_per_pixel_side ** 2
           if feats.get("enable_multiple_rays_per_pixel") else 0) + (
        params.samples_dof if feats.get("enable_depth_of_field") else 0)
    primary = n_px * max(spp, 1)
    shadow = (primary * params.parallelogram_light_direction_samples ** 2
              if feats.get("enable_soft_shadow") else 0)
    row = dict(label=label, ms=ms, frames=frames, first_s=first_s,
               peak_mib=peak, lit=lit, primary=primary, shadow=shadow,
               launches={k: launches[k] for k in ("keys", "walk", "sweep")},
               plain=plain)
    ops_txt = "; ".join(f"{k} {c} calls {t:.3f} ms {n} kernels"
                        for k, (c, t, n) in plain.items() if c)
    rays = (f", {shadow} shadow rays a frame (5x5 a primary ray), "
            f"{n_px * (1 + 25) / ms / 1e3:.3f} Mrays/s as bench.py:206 "
            f"counts" if shadow else "")
    log(f"  {label} ({side}x{side}): {primary} primary rays, launches "
        f"{row['launches']}, lit {lit:.3f}, first frame (profiled) "
        f"{first_s:.2f} s, frames ms {[round(x, 2) for x in frames]}, "
        f"median {ms:.2f} ms{rays}, peak memory {peak:.0f} MiB | plain ops "
        f"in the first frame: {ops_txt or 'none'}")
    return row


@contextlib.contextmanager
def recorded_batches(module, name, n_rays: int):
    """While open, records the arguments ((args), kwargs) of each call of
    module.name whose first argument holds at least n_rays rays; the calls
    run as before."""
    fn = getattr(module, name)
    calls = []

    def spy(o, *args, **kw):
        if o.shape[0] >= n_rays:
            calls.append(((o, *args), kw))
        return fn(o, *args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def slice_blocks(live):
    """The blocks the twins check of a batch: SLICE_BLOCKS - 2 spread over
    the blocks that hold a live ray, and the last two. live: [NB] bool."""
    import torch

    nb = live.shape[0]
    cand = torch.nonzero(live[:nb - 2]).flatten()
    if cand.numel():
        cand = cand[torch.linspace(0, cand.numel() - 1, SLICE_BLOCKS - 2,
                                   device=cand.device).round().long()]
    return torch.cat([cand, torch.tensor([nb - 2, nb - 1],
                                         device=cand.device)]).unique()


def shadow_batch(scene, feats, module, name):
    """One soft512 frame with each SHADOW_BATCH-ray call of module.name
    recorded: the arguments of the call with the most live rays (the third
    argument is the rays' budget, -1 for a dead ray)."""
    import cge_tpu_torch as ct

    f, params = ct.Features(**feats), ct.RenderParams()
    with recorded_batches(module, name, SHADOW_BATCH) as calls:
        ct.render_image(scene, ct.Camera(), f, params, W, H, FIFTH_SEED)
    if not calls:
        raise AssertionError(f"the soft512 frame sent {name} no batch of "
                             f"{SHADOW_BATCH} rays")
    return max(calls, key=lambda c: int((c[0][2] >= 0).sum()))


def check_shadow_k3(scene, device):
    """K3 on a full shadow batch of the accel-off soft512 frame
    (check_sweep_batch)."""
    from cge_tpu_torch.ops import sweep

    (o, d, tmax, table), _ = shadow_batch(scene, SOFT, sweep, "closest_tris")
    check_sweep_batch("one full shadow batch (accel off)", o, d, tmax, table,
                      device)


def check_sweep_batch(what, o, d, tmax, table, device):
    """K3 on one full batch: its ms, bound and share, and t and ids equal
    to the twin's on the rays of slice_blocks."""
    import torch

    from cge_tpu_torch.ops import sweep
    from cge_tpu_torch.tools import common, roofline

    got = sweep.closest_tris(o, d, tmax, table)
    live = torch.nn.functional.pad(tmax >= 0, (0, (-o.shape[0]) % 512))
    rows = (slice_blocks(live.reshape(-1, 512).any(dim=1))[:, None] * 512
            + torch.arange(512, device=device)).reshape(-1)
    rows = rows[rows < o.shape[0]]
    want = sweep.closest_tris_plain(o[rows], d[rows], tmax[rows], table)
    for name, a, b in zip(("t", "ids"), got, want):
        if not bool((a[rows] == b).all()):
            raise AssertionError(f"K3 on {what}: {name} differ from the "
                                 f"twin")
    ms = common.device_ms(lambda: sweep.closest_tris(o, d, tmax, table),
                          device, 3)
    bound = roofline.sweep_bound(o, d, tmax, table, got[0])
    log(f"    K3 on {what}: {o.shape[0]} rays, "
        f"{int((tmax >= 0).sum())} live, {int((got[1] >= 0).sum())} "
        f"hit, {table.shape[0]} triangles | {ms:.4f} ms, "
        f"{_bound_line(bound, ms)} | t and ids equal to the twin on "
        f"{rows.numel()} rays ({int((tmax[rows] >= 0).sum())} live) in "
        f"runs of 512, the last two among them")


def _live(call) -> int:
    """The live rays (budget >= 0) of a recorded call."""
    return int((call[0][2] >= 0).sum())


def _fullest(calls):
    """The recorded call with the most live rays; among equals the middle
    one in call order (of a frame's primary chunks, one across the
    image's middle rather than its top rows)."""
    most = max(_live(c) for c in calls)
    tied = [c for c in calls if _live(c) == most]
    return tied[len(tied) // 2]


def check_recorded(what, calls, accel: bool, device):
    """The kernels of a recorded run held to their twins at the run's own
    shapes: with the accel, K1 and K2 on its fullest closest batch and
    its fullest any-hit batch (check_walk_batch); without, K3 on its
    fullest batch (check_sweep_batch); the fullest as _fullest picks it."""
    from cge_tpu_torch.ops import cluster_sweep as cs

    if not calls:
        raise AssertionError(f"{what}: no batch was recorded")
    if not accel:
        (o, d, tmax, table), _ = _fullest(calls)
        check_sweep_batch(f"{what}, its fullest batch", o, d, tmax, table,
                          device)
        return
    for any_hit in (False, True):
        mode = "any-hit" if any_hit else "closest"
        batches = [c for c in calls if bool(c[1].get("any_hit")) == any_hit]
        if not batches:
            raise AssertionError(f"{what}: no {mode} batch")
        (o, d, tmax, aabbs, tiles, layout), kw = _fullest(batches)
        if (not kw.get("exact_keys", True) or kw.get("refine_members")
                or kw.get("mxu")):
            raise AssertionError(f"{what}: the {mode} sweep ran with {kw}")
        check_walk_batch(f"{what}, its fullest {mode} batch", o, d, tmax,
                         aabbs, tiles, layout, kw.get("br", cs.DEFAULT_BR),
                         kw.get("sc_n"), device, any_hit=any_hit,
                         shared_origin=kw.get("shared_origin", False))


def check_shadow_walk(scene, device):
    """K1 and K2's any-hit walk on a full shadow batch of the accel-on
    soft512 frame (check_walk_batch)."""
    from cge_tpu_torch.ops import cluster_sweep as cs

    args, kw = shadow_batch(scene, dict(SOFT, enable_accel_structure=True),
                            cs, "cluster_tris")
    if not kw.get("any_hit") or not kw.get("exact_keys", True):
        raise AssertionError(f"the shadow sweep ran with {kw}")
    check_walk_batch("one full shadow batch, the stand-in's soft512 frame "
                     "(accel on, reversed)",
                     *args, kw.get("br", cs.DEFAULT_BR), kw.get("sc_n"),
                     device)


def check_dragon_shadow_walk(scene, accel, device):
    """K1 and K2's any-hit walk on a shadow batch of SHADOW_BATCH rays over
    the dragon's 4,800 clusters at one a visit (the main path's sc_n):
    kernel_bench's shadow rays toward the hits of the 1280x1280 frame
    (check_walk_batch)."""
    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.tools import kernel_bench

    side = int(round(SHADOW_BATCH ** 0.5))
    batch = kernel_bench.walk_batches(scene, accel, device, side,
                                      SHADOW_BATCH)["c_shadow"]
    o, d, tmax = batch[:3]
    check_walk_batch(f"one full shadow batch, the dragon, shadow rays of a "
                     f"{side}x{side} frame",
                     o, d, tmax, accel.aabbs, accel.tiles, accel.layout,
                     cs.DEFAULT_BR, MAIN_PARAMS["sweep_anyhit_sc_n"], device)


def check_walk_batch(what, o, d, tmax, aabbs, tiles, layout, br, sc_n,
                     device, any_hit: bool = True,
                     shared_origin: bool = False):
    """K1, the sort of its keys and K2's walk (any-hit, or closest, with
    the shared-origin hoist where the batch was swept with it) on one
    full batch: the key table's bytes, each one's ms with K1's and K2's
    bounds; K1's keys and K2's results bit for bit against the twins on
    the blocks of slice_blocks."""
    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.tools import common, kernel_bench, roofline

    inp = cs.sweep_setup(o, d, tmax, aabbs, tiles, layout, br, sc_n)
    keys = cs.block_entry_keys(inp.rays, inp.boxes)
    skeys, order = cs.sort_keys(keys)
    walk = dict(layout=layout, sc_n=inp.sc_n, any_hit=any_hit,
                shared_origin=shared_origin)
    out = cs.cluster_walk(order, skeys, inp.rays, inp.tiles, **walk)
    blocks = slice_blocks((inp.rays[:, 6] >= 0).any(dim=1))
    kernel_bench.check_keys(
        keys[blocks], cs.block_entry_keys_plain(inp.rays[blocks], inp.boxes),
        f"K1 on {what}")
    kernel_bench.check_equal(
        [x[blocks] for x in out],
        cs.cluster_walk_plain(order[blocks], skeys[blocks], inp.rays[blocks],
                              inp.tiles, **walk),
        f"K2 on {what}")
    keys_ms = common.device_ms(
        lambda: cs.block_entry_keys(inp.rays, inp.boxes), device, 3)
    sort_ms = common.device_ms(lambda: cs.sort_keys(keys), device, 3)
    walk_ms = common.device_ms(lambda: cs.cluster_walk(
        order, skeys, inp.rays, inp.tiles, **walk), device, 3)
    keys_bound = roofline.keys_bound(inp.rays, inp.boxes.shape[0])
    walk_bound = roofline.walk_bound(order, inp.rays, inp.tiles, out, **walk)
    NB, _, BR = inp.rays.shape
    blocked = (out[1] == 1) if any_hit else (out[1] >= 0)
    log(f"    K1 + K2 ({'any-hit' if any_hit else 'closest'}"
        f"{', shared origin' if shared_origin else ''}) on {what}: "
        f"{o.shape[0]} rays "
        f"in {NB} blocks of {BR}, {int((tmax >= 0).sum())} live, "
        f"{int(blocked.sum())} {'blocked' if any_hit else 'hit'}, "
        f"{inp.boxes.shape[0]} boxes, "
        f"key table {keys.numel() * 4} bytes | K1 {keys_ms:.4f} ms, "
        f"{_bound_line(keys_bound, keys_ms)} | sort {sort_ms:.4f} ms | K2 "
        f"{walk_ms:.4f} ms, {_bound_line(walk_bound, walk_ms)}, visits mean "
        f"{float(out[2].float().mean()):.2f} max {int(out[2].max())} | K1's "
        f"keys and K2's t, ids, visits and dense tiles equal to the twins "
        f"on {blocks.numel()} blocks ({int((inp.rays[blocks, 6] >= 0).sum())}"
        f" live rays), the last two among them")


def check_plain_ops_reader(tmp, device) -> None:
    """frame_profile.plain_ops against torch.profiler's own parse of the
    same trace (each label's events with their child ops' kernels) on two
    64x64 frames of the small stand-in that run every labelled part: equal
    calls and kernels, and device ms within 1e-6."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cge_tpu_torch as ct
    from cge_tpu_torch.tools import frame_profile as fp

    def parsed(prof, labels):
        def kernels(e):
            return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

        out = {name: [0, 0.0, 0] for name in labels.values()}
        for e in prof.events():
            if e.name in labels and e.device_type.name == "CPU":
                row = out[labels[e.name]]
                row[0] += 1
                row[1] += e.device_time_total / 1e3
                row[2] += kernels(e)
        return out

    scenes = fifth_scenes(tmp, (41, 32), device)
    labels = fp.LABELS
    for which, feats in (("tex", dict(
            HEADLINE, enable_texture_mapping=True,
            enable_bilinear_texture_filtering=True, enable_bloom_effect=True,
            enable_multiple_rays_per_pixel=True)), ("par", SOFT)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ct.render_image(scenes[which], ct.Camera(), ct.Features(**feats),
                            ct.RenderParams(), SMALL_SIDE, SMALL_SIDE,
                            FIFTH_SEED)
            torch.cuda.synchronize()
        got = fp.plain_ops(fp.read_events(prof), labels)
        want = parsed(prof, labels)
        for k, (calls, ms, n) in got.items():
            w_calls, w_ms, w_n = want[k]
            if calls != w_calls or n != w_n or abs(ms - w_ms) > 1e-6:
                raise AssertionError(f"plain_ops read {k} as {got[k]}, "
                                     f"torch.profiler's parse as {want[k]}")
    log(f"    plain_ops equals torch.profiler's own parse on two "
        f"{SMALL_SIDE}x{SMALL_SIDE} frames that run every labelled part")


def threefry_check(device) -> None:
    """The card's threefry draws equal the CPU's bit for bit: one chunk's
    per-ray soft-shadow streams (65,536 global ids from the second chunk,
    25 samples each), the 64x64 frame's MSAA jitter and its DoF split."""
    import torch

    from cge_tpu_torch.ops import rng

    key = rng.fold_in(rng.prng_key(FIFTH_SEED), 3)
    ids = torch.arange(65536, 2 * 65536)
    draws = [
        lambda dev: rng.per_ray_uniform(rng.fold_in(key, 2000), ids.to(dev),
                                        (25,)),
        lambda dev: rng.uniform(rng.fold_in(key, 101), (64 * 64, 9, 2), dev),
        lambda dev: rng.uniform(rng.split(rng.fold_in(key, 202))[1],
                                (64 * 64, 5), dev)]
    for i, draw in enumerate(draws):
        a, b = draw(device).cpu(), draw(torch.device("cpu"))
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"threefry draw {i}: card and CPU differ")
    log(f"    threefry: {len(draws)} draws (a chunk's per-ray streams, "
        f"MSAA jitter, DoF disk) equal on card and CPU bit for bit")


def fifth_small_check(tmp, device) -> list:
    """Each phase-11 feature set on the 41x32 stand-in at 64x64 with the
    same seed on the card and the CPU twins, under phase 4's rule."""
    import torch

    import cge_tpu_torch as ct

    card = fifth_scenes(tmp, (41, 32), device)
    cpu = fifth_scenes(tmp, (41, 32), torch.device("cpu"))
    out = []
    for label, which, feats in FIFTH_ROWS:
        f = ct.Features(**feats)
        p = ct.RenderParams(trace_chunk=1024)
        a, b = (ct.render_image(s[which], ct.Camera(), f, p, SMALL_SIDE,
                                SMALL_SIDE, FIFTH_SEED).cpu().numpy()
                for s in (card, cpu))
        nan_agree, frac = compare_images(a, b)
        out.append((label, nan_agree, frac))
        if nan_agree < 0.999 or frac < 0.995:
            raise AssertionError(f"{label}: card and CPU disagree "
                                 f"({nan_agree:.4f} NaN, {frac:.4%} close)")
    log(f"    {SMALL_SIDE}x{SMALL_SIDE} card vs CPU twins: " + "; ".join(
        f"{label} {frac:.2%}" for label, _, frac in out))
    return out


def fifth_path(tmp, dragon, accel, device) -> list:
    """Phase 11; dragon and accel: the main path's scene and accel."""
    log(f"[11] fifth path: texture, soft shadows, bloom, MSAA, DoF at "
        f"{W}x{H} (MSAA and DoF at 256x256) on the "
        f"{2 * (TEAPOT_GRID[0] - 1) * TEAPOT_GRID[1]}-"
        f"triangle stand-in (seed {FIFTH_SEED}; texture {TEX_HW[1]}x"
        f"{TEX_HW[0]})")
    scenes = fifth_scenes(tmp, TEAPOT_GRID, device)
    tex = scenes["tex"]
    if tuple(tex.tex_hw[0].tolist()) != TEX_HW:
        raise AssertionError(f"texture loaded as {tex.tex_hw[0].tolist()}")
    from cge_tpu_torch.tools.frame_profile import LABELS

    rows = [fifth_frame(label, scenes[which], feats, LABELS)
            for label, which, feats in FIFTH_ROWS]
    check_shadow_k3(scenes["par"], device)
    check_shadow_walk(scenes["par"], device)
    check_dragon_shadow_walk(dragon, accel, device)
    check_plain_ops_reader(tmp, device)
    threefry_check(device)
    fifth_small_check(tmp, device)
    return rows


# ---------------------------------------------------------------------------
# phase 12: transparency shadows, the TRANS+REC tree, glossy, batches
# ---------------------------------------------------------------------------

TREE = dict(enable_shading=True, enable_hard_shadow=True,
            enable_recursive=True, enable_transparency=True,
            enable_normal_interp=True)
GLOSSY = dict(enable_shading=True, enable_hard_shadow=True,
              enable_recursive=True, enable_glossy_reflection=True,
              enable_normal_interp=True)
# bench.py:230-234: glossy at 256x256 in 16,384-ray chunks, 40 cone
# samples a reflection (the default rays_per_reflection)
GLOSSY_PARAMS = dict(trace_chunk=16384)
SIXTH_FRAMES = 1
BATCH_CAMERAS = (dict(), dict(rotation=(0.5, -0.4, 0.0)),
                 dict(distance=2.4, rotation=(0.2, 1.1, 0.0)))
# (label, material variant of the stand-in (tools/common.py
# MATERIAL_VARIANTS), features, params, side) of each frame; accel off
# must launch K3 only, accel on K1 and K2 only
SIXTH_ROWS = (
    ("transrec512, accel off", "glass", TREE, {}, 512),
    ("transrec512, accel on", "glass",
     dict(TREE, enable_accel_structure=True), {}, 512),
    ("transrec512 all-diffuse, accel off", "diffuse_glass", TREE, {}, 512),
    ("glossy256, accel off", "glossy", GLOSSY, GLOSSY_PARAMS, 256),
    ("glossy256, accel on", "glossy",
     dict(GLOSSY, enable_accel_structure=True), GLOSSY_PARAMS, 256),
)
# the same feature sets on the 41x32 stand-in at 64x64, card against the
# CPU twins (and the transparency-only chain with shadows); the accel-off
# tree and glossy at a cut depth: K3's CPU twin takes 60-80 s at full
SIXTH_SMALL = (
    ("transparency chain + shadows", "glass",
     dict(TREE, enable_recursive=False), {}),
    ("transrec, accel on", "glass", dict(TREE, enable_accel_structure=True),
     {}),
    ("transrec, accel off, depth 2", "glass", TREE, dict(ray_depth=2)),
    ("transrec all-diffuse", "diffuse_glass", TREE, {}),
    ("glossy, accel on", "glossy", dict(GLOSSY, enable_accel_structure=True),
     {}),
    ("glossy, accel off, depth 2, 8 a reflection", "glossy", GLOSSY,
     dict(ray_depth=2, rays_per_reflection=8)),
)


def sixth_scenes(tmp, grid, device):
    """The stand-in at `grid` on `device` in each material variant, lit by
    the point light."""
    import cge_tpu_torch as ct
    from cge_tpu_torch.tools.common import (MATERIAL_VARIANTS,
                                            write_variant_obj)

    out = {}
    for variant in MATERIAL_VARIANTS:
        path = os.path.join(tmp, f"standin_{variant}_{grid[0]}x{grid[1]}.obj")
        if not os.path.exists(path):
            write_variant_obj(path, *grid, variant)
        out[variant] = ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)],
                                               device=device)
    return out


@contextlib.contextmanager
def level_rays():
    """While open, records the rays and live rays of each trace level:
    yields a list that ends up with [rays, live] per level, summed over
    the chunks (each chunk a call of the renderer's trace)."""
    from cge_tpu_torch.render import renderer, wavefront

    shade, trace = wavefront._intersect_and_shade, renderer.trace
    chunks = []

    def trace_spy(*args, **kw):
        chunks.append([])
        return trace(*args, **kw)

    def shade_spy(scene, o, d, features, params, alive, *args, **kw):
        chunks[-1].append((o.shape[0], int(alive.sum())))
        return shade(scene, o, d, features, params, alive, *args, **kw)

    levels = []
    wavefront._intersect_and_shade, renderer.trace = shade_spy, trace_spy
    try:
        yield levels
    finally:
        wavefront._intersect_and_shade, renderer.trace = shade, trace
        for chunk in chunks:
            for i, (n, live) in enumerate(chunk):
                if i == len(levels):
                    levels.append([0, 0])
                levels[i][0] += n
                levels[i][1] += live


def sixth_frame(label, scene, feats, pdict, side):
    """One row of phase 12: the first frame with the counters reset around
    it and the rays of each level recorded, then SIXTH_FRAMES timed frames
    (CUDA events) with peak memory. Returns the row."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct

    f, params = ct.Features(**feats), ct.RenderParams(**pdict)
    ctx = ct.prepare_render(scene, f, params)
    reset_launches()
    t0 = time.perf_counter()
    with level_rays() as levels:
        img = ct.render_image_u8(scene, ct.Camera(), f, params, side, side,
                                 FIFTH_SEED, ctx=ctx)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if img.shape != (side, side, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"{label}: image {tuple(img.shape)} {img.dtype}")
    lit = float((img.float().sum(-1) > 0).float().mean())
    if lit < 0.05:
        raise AssertionError(f"{label}: image is blank ({lit:.4f} lit)")
    want = ("keys", "walk") if feats.get("enable_accel_structure") else (
        "sweep",)
    other = {"keys", "walk", "sweep", "walk_refine", "walk_mxu"} - set(want)
    if (any(launches[k] <= 0 for k in want)
            or any(launches[k] for k in other)):
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(SIXTH_FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ct.render_image_u8(scene, ct.Camera(), f, params, side, side,
                           FIFTH_SEED, ctx=ctx)
        end.record()
        torch.cuda.synchronize()
        frames.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = float(np.median(frames))
    row = dict(label=label, ms=ms, frames=frames, first_s=first_s,
               peak_mib=peak, lit=lit, levels=levels,
               launches={k: launches[k] for k in ("keys", "walk", "sweep")})
    log(f"  {label}: {side}x{side}, launches {row['launches']}, lit "
        f"{lit:.3f}, first frame {first_s:.2f} s, frames ms "
        f"{[round(x, 2) for x in frames]}, median {ms:.2f} ms, peak memory "
        f"{peak:.0f} MiB | rays per level (live), summed over chunks: "
        f"{', '.join(f'{n} ({live})' for n, live in levels)}")
    return row


def check_transparency_shadow_walk(scene, device):
    """K1 + sort + K2's closest-mode walk on the fullest forward
    transparency-shadow batch of the accel-on transrec512 frame (the
    batch of lights.closest_hit with the most live rays), bit for bit
    against the twins (check_walk_batch)."""
    import cge_tpu_torch as ct
    from cge_tpu_torch.render import lights

    fn, best = lights.closest_hit, {"live": -1}

    def spy(scene_, o, d, tmax, accel=None, **kw):
        live = int((tmax >= 0).sum())
        if live > best["live"]:
            best.update(live=live, args=(o, d, tmax, accel, kw))
        return fn(scene_, o, d, tmax, accel, **kw)

    lights.closest_hit = spy
    try:
        ct.render_image(scene, ct.Camera(),
                        ct.Features(**TREE, enable_accel_structure=True),
                        ct.RenderParams(), W, H, FIFTH_SEED)
    finally:
        lights.closest_hit = fn
    if best["live"] < 0 or best["args"][3] is None:
        raise AssertionError("the accel-on transrec512 frame sent no "
                             "transparency-shadow batch through the accel")
    o, d, tmax, accel, kw = best["args"]
    if not kw.get("exact_keys", True):
        raise AssertionError(f"the transparency-shadow sweep ran with {kw}")
    check_walk_batch(
        "one full shadow batch, the stand-in's transrec512 frame "
        "(transparency shadows, forward)",
        o, d, tmax, accel.aabbs, accel.tiles, accel.layout, kw["br"],
        kw["sc_n"], device, any_hit=False)


def batch_check(scene, ctx, device) -> dict:
    """Three headline cameras of the main path's scene through
    render_images_u8 (the counters reset around it: K1 and K2 only), equal
    to three render_image_u8 calls with seeds SEED + i bit for bit."""
    import torch

    import cge_tpu_torch as ct

    feats, params = ct.Features(**HEADLINE), ct.RenderParams(**MAIN_PARAMS)
    cams = ct.stack_cameras(ct.Camera(**c) for c in BATCH_CAMERAS)
    reset_launches()
    t0 = time.perf_counter()
    batch = ct.render_images_u8(scene, cams, feats, params, W, H, SEED,
                                ctx=ctx)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = read_launches()
    if launches["keys"] <= 0 or launches["walk"] <= 0 or launches["sweep"]:
        raise AssertionError(f"the batch launched {launches}")
    singles = [ct.render_image_u8(scene, cam, feats, params, W, H, SEED + i,
                                  ctx=ctx) for i, cam in enumerate(cams)]
    if batch.shape != (len(cams), H, W, 3) or not all(
            torch.equal(batch[i], one) for i, one in enumerate(singles)):
        raise AssertionError("render_images_u8 differs from render_image_u8")
    if torch.equal(batch[0], batch[1]):
        raise AssertionError("two cameras of the batch gave one image")
    counts = {k: launches[k] for k in ("keys", "walk", "sweep")}
    log(f"  batch: {len(cams)} headline cameras of the dragon at {W}x{H} "
        f"through render_images_u8 in {batch_s:.2f} s, launches {counts}, "
        f"equal to {len(cams)} render_image_u8 calls bit for bit")
    return launches


def sixth_small_check(tmp, device) -> list:
    """Each SIXTH_SMALL feature set on the 41x32 stand-in at 64x64 with the
    same seed on the card and the CPU twins, under phase 4's rule."""
    import torch

    import cge_tpu_torch as ct

    card = sixth_scenes(tmp, (41, 32), device)
    cpu = sixth_scenes(tmp, (41, 32), torch.device("cpu"))
    out = []
    for label, which, feats, pdict in SIXTH_SMALL:
        f = ct.Features(**feats)
        p = ct.RenderParams(trace_chunk=1024, **pdict)
        t0 = time.perf_counter()
        a, b = (ct.render_image(s[which], ct.Camera(), f, p, SMALL_SIDE,
                                SMALL_SIDE, FIFTH_SEED).cpu().numpy()
                for s in (card, cpu))
        nan_agree, frac = compare_images(a, b)
        out.append((label, nan_agree, frac, time.perf_counter() - t0))
        if nan_agree < 0.999 or frac < 0.995:
            raise AssertionError(f"{label}: card and CPU disagree "
                                 f"({nan_agree:.4f} NaN, {frac:.4%} close)")
    log(f"    {SMALL_SIDE}x{SMALL_SIDE} card vs CPU twins: " + "; ".join(
        f"{label} {frac:.2%} ({s:.1f} s)" for label, _, frac, s in out))
    return out


def sixth_path(tmp, dragon, ctx, device) -> list:
    """Phase 12; dragon and ctx: the main path's scene and context."""
    log(f"[12] sixth path: transparency shadows, the TRANS+REC tree, glossy "
        f"and batched cameras on the "
        f"{2 * (TEAPOT_GRID[0] - 1) * TEAPOT_GRID[1]}-triangle stand-in "
        f"(seed {FIFTH_SEED})")
    scenes = sixth_scenes(tmp, TEAPOT_GRID, device)
    rows = [sixth_frame(label, scenes[which], feats, pdict, side)
            for label, which, feats, pdict, side in SIXTH_ROWS]
    check_transparency_shadow_walk(scenes["glass"], device)
    batch_check(dragon, ctx, device)
    sixth_small_check(tmp, device)
    return rows


# ---------------------------------------------------------------------------
# phase 13: the CLI and config, the reference BVH, the debugger, the app
# ---------------------------------------------------------------------------

CLI_CAMERAS = """
[[cameras]]

[[cameras]]
field_of_view = 40.0
distance_from_look_at = 2.5
rotation = [10.0, -30.0, 0.0]

[[cameras]]
field_of_view = 60.0
look_at = [0.1, 0.0, 0.0]
rotation = [30.0, 60.0, 0.0]
"""
# the traversal's tolerance against K3 (tests/test_bvh_traverse.py)
TRAVERSAL_RTOL, TRAVERSAL_ATOL = 5e-6, 1e-7
SMI = {"line": ""}


def cli_toml(tmp, name, obj, side, accel, cameras=CLI_CAMERAS) -> tuple:
    """A config file of the CLI for obj with the headline features, the
    given cameras and one point light at (-1, 1, -1); (path, output
    directory)."""
    out = os.path.join(tmp, f"{name}_out")
    path = os.path.join(tmp, f"{name}.toml")
    with open(path, "w") as f:
        f.write(f"""window_size = [{side}, {side}]
data_path = "{os.path.dirname(obj)}"
scene = "{os.path.basename(obj)}"
output_dir = "{out}"

[features]
enable_shading = true
enable_hard_shadow = true
enable_recursive = true
enable_normal_interp = true
enable_accel_structure = {str(accel).lower()}
{cameras}
[[lights]]
type = "point"
position = [-1.0, 1.0, -1.0]
color = [1.0, 1.0, 1.0]
""")
    return path, out


def _bmps(out) -> list:
    """The CLI's BMPs in an output directory, by camera index."""
    names = [n for n in os.listdir(out) if n.endswith(".bmp")]
    return [os.path.join(out, n) for n in
            sorted(names, key=lambda n: int(n[:-4].rsplit("_", 1)[1]))]


def cli_row(tmp, label, obj, ref_scene, accel, device) -> dict:
    """One config through `python -m cge_tpu_torch.cli` in a subprocess
    and through cli.run in this process with the launch counters reset;
    every BMP of both must equal, byte for byte, write_bmp of
    render_images for the same cameras on ref_scene (the same OBJ loaded
    in this process). The in-process run's batches are recorded and its
    kernels held to their twins on them (check_recorded)."""
    import io

    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch import cli
    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.ops import sweep
    from cge_tpu_torch.scene.image_io import read_bmp, write_bmp

    toml, out = cli_toml(tmp, label, obj, W, accel)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cge_tpu_torch.cli", toml],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{label}: the CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    sub_took = [ln for ln in r.stdout.splitlines()
                if ln.startswith("Rendering took")]
    sub_paths = _bmps(out)
    for p in sub_paths:
        os.rename(p, p[:-4] + ".sub.bmp")
    sub_paths = [p[:-4] + ".sub.bmp" for p in sub_paths]

    config = ct.read_config_file(toml)
    spied = (cs, "cluster_tris") if accel else (sweep, "closest_tris")
    reset_launches()
    buf = io.StringIO()
    with recorded_batches(*spied, 1) as calls, \
            contextlib.redirect_stdout(buf):
        paths = cli.run(config, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    took = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("Rendering took")]
    if len(paths) != 3 or len(sub_paths) != 3 or len(took) != 1:
        raise AssertionError(f"{label}: {len(paths)} / {len(sub_paths)} "
                             f"BMPs, output {buf.getvalue()!r}")
    kernels = ("keys", "walk") if accel else ("sweep",)
    for k in ("keys", "walk", "sweep"):
        if (launches[k] > 0) != (k in kernels):
            raise AssertionError(f"{label}: launches {launches}")

    cams = [c.to_camera(aspect=1.0) for c in config.cameras]
    params = ct.RenderParams()
    imgs = ct.render_images(ref_scene, cams, config.features, params, W, H,
                            0, ct.prepare_render(ref_scene, config.features,
                                                 params)).cpu().numpy()
    lit = []
    for i, img in enumerate(imgs):
        ref = os.path.join(tmp, f"{label}_ref_{i}.bmp")
        write_bmp(ref, img)
        with open(ref, "rb") as f:
            want = f.read()
        for p in (paths[i], sub_paths[i]):
            with open(p, "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"{label}: {p} differs from "
                                         f"write_bmp of render_images")
            if not (read_bmp(p) == read_bmp(ref)).all():
                raise AssertionError(f"{label}: read_bmp({p}) differs")
        lit.append(float((read_bmp(ref).sum(-1) > 0).mean()))
    if min(lit) < 0.05:
        raise AssertionError(f"{label}: a blank camera, lit {lit}")
    log(f"  {label}: {int(ref_scene.tri_mask.sum())} triangles, 3 cameras "
        f"at {W}x{H}, launches {launches}; in process: {took[0]}; "
        f"subprocess {sub_s:.1f} s: {sub_took[0] if sub_took else '-'}; "
        f"lit {[round(x, 3) for x in lit]}; 6 BMPs equal to write_bmp of "
        f"render_images byte for byte | {SMI['line']}")
    check_recorded(f"the {label} run", calls, accel, device)
    return dict(launches=launches, took=took[0])


def cli_small_check(tmp, device) -> None:
    """Two cameras of the 41x32 stand-in at 64x64 through cli.run on the
    card and on the CPU twins, under phase 4's rule."""
    import numpy as np

    import cge_tpu_torch as ct
    from cge_tpu_torch import cli
    from cge_tpu_torch.scene.image_io import read_bmp

    obj = os.path.join(tmp, "dragon_small.obj")
    two = CLI_CAMERAS.rsplit("[[cameras]]", 1)[0]
    rows = []
    for dev in (device, "cpu"):
        name = "small_" + str(dev).replace(":", "")
        toml, _ = cli_toml(tmp, name, obj, 64, True, two)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            paths = cli.run(ct.read_config_file(toml), device=dev)
        rows.append([read_bmp(p) for p in paths])
    res = [compare_images(a, b) for a, b in zip(*rows)]
    log(f"    CLI 41x32 stand-in, 2 cameras at 64x64, card vs CPU twins: "
        f"{[(round(n, 5), f'{f:.4%}') for n, f in res]}")
    if len(res) != 2 or any(n < 0.999 or f < 0.995 for n, f in res):
        raise AssertionError("CLI card and CPU images disagree")
    if not np.any(rows[0][0]):
        raise AssertionError("CLI small image is blank")


def to_cpu(scene):
    """A CPU copy of a scene on the card."""
    import dataclasses

    from cge_tpu_torch.scene.scene import TENSOR_FIELDS

    return dataclasses.replace(scene, **{k: getattr(scene, k).cpu()
                                         for k in TENSOR_FIELDS})


# the primary rays the reference BVH's traversal checks, a side (the
# traversal took 6-8 s on the card and 11 s on the CPU at 256)
BVH_SIDE = 128


def bvh_check(tscene, device) -> dict:
    """The reference BVH of the stand-in, median and SAH, and its parity
    traversal for BVH_SIDE x BVH_SIDE primary rays on the card: against
    K3's closest hit (hit masks equal, t within the traversal tolerance,
    ids equal off exact-t ties) and, for the median BVH, the CPU run bit
    for bit."""
    import torch

    from cge_tpu_torch.ops import bvh_traverse as bt
    from cge_tpu_torch.ops.intersect import closest_hit
    from cge_tpu_torch.utils.profiling import timed_bvh_build

    o, d = camera_rays(BVH_SIDE, device)
    tm = torch.full((o.shape[0],), torch.inf, device=device)
    reset_launches()
    k3 = closest_hit(tscene, o, d, tm)
    k3_launches = read_launches()["sweep"]
    rows = {}
    for sah in (False, True):
        bvh, stats = timed_bvh_build(tscene, sah_binning=sah)
        db = bt.device_bvh(bvh, tscene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit, t, sph, prim = bt.bvh_closest_hit(db, o, d, tm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(hit, k3.hit):
            raise AssertionError(f"traversal (sah={sah}) and K3 disagree on "
                                 f"{int((hit != k3.hit).sum())} hit masks")
        h = hit
        close = torch.isclose(t[h], k3.t[h], rtol=TRAVERSAL_RTOL,
                              atol=TRAVERSAL_ATOL)
        if not bool(close.all()):
            raise AssertionError(f"traversal t off K3's on "
                                 f"{int((~close).sum())} rays")
        ties = int((h & (prim != k3.prim)).sum())
        if ties > max(1, int(h.sum()) // 100):
            raise AssertionError(f"traversal ids differ from K3's on {ties} "
                                 f"rays")
        name = "sah" if sah else "median"
        rows[name] = dict(build_ms=stats.build_ms, ms=ms)
        line = (f"    reference BVH {name}: build {stats.build_ms:.1f} ms, "
                f"{stats.num_levels} levels, {stats.num_leaves} leaves, max "
                f"{stats.max_per_leaf} a leaf; traversal of {o.shape[0]} "
                f"primary rays {ms:.1f} ms; {int(h.sum())} hits, equal to "
                f"K3's hit mask "
                f"({k3_launches} K3 launch), t within rtol "
                f"{TRAVERSAL_RTOL} / atol {TRAVERSAL_ATOL}, ids differ on "
                f"{ties} exact-t ties")
        if not sah:
            t0 = time.perf_counter()
            cpu = bt.bvh_closest_hit(bt.device_bvh(bvh, to_cpu(tscene)),
                                     o.cpu(), d.cpu(), tm.cpu())
            cpu_s = time.perf_counter() - t0
            for a, b in zip((hit, t, sph, prim), cpu):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("traversal: card and CPU differ")
            line += f"; the CPU run ({cpu_s:.1f} s) equal bit for bit"
        log(line + f" | {SMI['line']}")
    return rows


def debugger_check(dragon, device) -> None:
    """debug_trace of a 4x4 pixel fan into the dragon with mirrors on,
    card (K3) against the CPU twins: the same levels, rays a level and
    hit masks."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.viz.debug import debug_trace

    feats = ct.Features(**BRUTE)
    grid = ct.camera.pixel_grid(4, 4, device).reshape(-1, 2) * 0.3
    o, d = ct.Camera().generate_rays(grid)
    reset_launches()
    t0 = time.perf_counter()
    card = debug_trace(dragon, o, d, feats, ct.RenderParams())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    cpu = debug_trace(to_cpu(dragon), o.cpu(), d.cpu(), feats,
                      ct.RenderParams())
    counts = [len(lv.hit) for lv in card]
    if counts != [len(lv.hit) for lv in cpu] or len(card) < 2:
        raise AssertionError(f"debugger levels: card {counts}, CPU "
                             f"{[len(lv.hit) for lv in cpu]}")
    for a, b in zip(card, cpu):
        if not np.array_equal(a.hit, b.hit):
            raise AssertionError("debugger hit masks differ")
    if launches["sweep"] <= 0:
        raise AssertionError(f"debug_trace launched {launches}")
    log(f"    debugger: a 4x4 fan into the dragon with mirrors, {len(card)} "
        f"levels, rays a level {counts}, hits a level "
        f"{[int(lv.hit.sum()) for lv in card]}, equal to the CPU twins'; "
        f"{ms:.1f} ms, launches {launches}")


def preview_app_check(tmp, tobj, tscene, device) -> dict:
    """The preview of the stand-in at 256x256, card against CPU (the share
    of pixels with the same triangle id); an AppState of the stand-in's
    OBJ on the card, a ray-traced frame (its kernels held to their twins
    on its recorded batches, check_recorded) and a raster frame, and its
    HTTP frame decoded against state.frame()."""
    import http.client

    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.app.server import serve
    from cge_tpu_torch.app.state import AppState
    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.raster import preview, rasterize
    from cge_tpu_torch.raster.matrices import (camera_matrices,
                                               project_vertices)
    from cge_tpu_torch.scene.image_io import decode_png

    side = 256
    cam = ct.Camera()
    soup = preview.preview_soup(tscene, cam, side)
    ids = []
    for dev in (device, "cpu"):
        verts, tris, _ = (torch.from_numpy(a).to(dev) for a in soup)
        view, proj = camera_matrices(cam, side, side, dev)
        xy, z, w = project_vertices(verts, view, proj, side, side)
        ids.append(rasterize(xy, z, w, tris, side, side)[0].cpu())
    same = float((ids[0] == ids[1]).float().mean())
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = preview.render_preview(tscene, cam, side, side)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    covered = float((ids[0] >= 0).float().mean())
    log(f"    preview {side}x{side}: {len(soup[1])} triangles, "
        f"{covered:.3f} covered, {same:.4%} of pixels with the card's and "
        f"the CPU's triangle id equal; render_preview ms "
        f"{[round(x, 1) for x in times]} | {SMI['line']}")
    if same < 0.999 or covered < 0.05 or float(img.max()) <= 0.05:
        raise AssertionError("preview: card and CPU differ, or blank")

    state = AppState(scene=tobj, width=side, height=side, device=device,
                     output_dir=os.path.join(tmp, "app_out"))
    state.update_features(HEADLINE)
    state.set_view(mode="raytrace")
    reset_launches()
    t0 = time.perf_counter()
    with recorded_batches(cs, "cluster_tris", 1) as calls:
        rt = state.frame()
    rt_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    if launches["keys"] <= 0 or launches["walk"] <= 0 or rt.max() < 20:
        raise AssertionError(f"app ray trace: launches {launches}")
    check_recorded("the app's ray-traced frame", calls, True, device)
    state.set_view(mode="raster")
    raster = state.frame()
    httpd = serve(state, port=0, background=True)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=120)
        conn.request("GET", "/api/frame")
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    if resp.status != 200 or resp.getheader("Content-Type") != "image/png":
        raise AssertionError(f"GET /api/frame: {resp.status}")
    served = decode_png(body)
    if not np.array_equal(served, state.frame()) \
            or not np.array_equal(served, raster):
        raise AssertionError("GET /api/frame differs from state.frame()")
    log(f"    app on the card: ray-traced frame {rt_ms:.1f} ms (first), "
        f"launches {launches}, lit {float((rt.sum(-1) > 0).mean()):.3f}; "
        f"raster frame; GET /api/frame ({len(body)} bytes of PNG) equal to "
        f"state.frame()")
    return dict(preview_ms=times[-1])


def profiler_checkpoint_check(tmp, tobj, tscene, device) -> None:
    """utils.profiling.trace around one CLI frame (the stand-in, accel on,
    one camera) must write a trace naming K2's kernel; utils.checkpoint
    saves and restores scene_params on the card unchanged."""
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch import cli
    from cge_tpu_torch.utils import checkpoint, profiling

    one = CLI_CAMERAS.split("[[cameras]]")[0] + "[[cameras]]\n"
    toml, _ = cli_toml(tmp, "traced", tobj, W, True, one)
    log_dir = os.path.join(tmp, "trace")
    config = ct.read_config_file(toml)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        with profiling.trace(log_dir):
            cli.run(config, device=device)
            torch.cuda.synchronize()
    files = os.listdir(log_dir)
    with open(os.path.join(log_dir, files[0])) as f:
        text = f.read()
    n = text.count("cluster_walk_split_kernel")
    if len(files) != 1 or n == 0:
        raise AssertionError(f"trace {files}: K2 named {n} times")
    ck = os.path.join(tmp, "ckpt")
    params = ct.scene_params(tscene)
    checkpoint.save(ck, 3, params)
    back = checkpoint.restore(ck, device=device)
    bad = [k for k, v in params.items()
           if back[k].device != v.device or not torch.equal(back[k], v)]
    if bad or checkpoint.latest_step(ck) != 3:
        raise AssertionError(f"checkpoint round trip: {bad}")
    log(f"    profiler: one CLI frame's Chrome trace ({len(text)} bytes) "
        f"names cluster_walk_split_kernel {n} times; checkpoint: "
        f"{len(params)} scene_params on the card restored unchanged")


def seventh_path(tmp, dragon, tobj, tscene, device) -> dict:
    """Phase 13; dragon and tscene: phase 3's and phase 5's scenes."""
    log(f"[13] seventh path: the CLI and config, the reference BVH and its "
        f"traversal, the debugger, the preview and the app | {SMI['line']}")
    obj = os.path.join(tmp, "dragon.obj")
    rows = {"cli_accel": cli_row(tmp, "cli_dragon_accel", obj, dragon, True,
                                 device),
            "cli_brute": cli_row(tmp, "cli_standin_brute", tobj, tscene,
                                 False, device)}
    cli_small_check(tmp, device)
    rows["bvh"] = bvh_check(tscene, device)
    debugger_check(dragon, device)
    rows.update(preview_app_check(tmp, tobj, tscene, device))
    profiler_checkpoint_check(tmp, tobj, tscene, device)
    return rows


# ---------------------------------------------------------------------------
# phase 14: multi-device on the one card, and the native host library
# ---------------------------------------------------------------------------

# (label, backend, world, timeout s, jobs): the worlds of phase 14, each
# started as rank processes of this script (`--rank SPEC`). NCCL takes one
# rank a card, so the multi-rank worlds on the one card run on gloo with
# CUDA tensors.
EIGHTH_SIDE = 512
EIGHTH_FRAMES = 1
GRID_SIDE = 256


def eighth_worlds() -> tuple:
    dragon = dict(features=HEADLINE, params=MAIN_PARAMS, side=EIGHTH_SIDE)
    brute = dict(features=BRUTE, params={}, side=EIGHTH_SIDE)
    return (
        ("nccl world of 1", "nccl", 1, 240, [
            dict(kind="frame", name="nccl_1x1", scene="dragon", mesh=(1, 1),
                 single=True, **dragon)]),
        ("nccl, 2 ranks on one card", "nccl", 2, 120, [
            dict(kind="refuse", name="nccl_refuse")]),
        ("gloo, 2 ranks on one card", "gloo", 2, 480, [
            dict(kind="frame", name="rays_2x1", scene="dragon", mesh=(2, 1),
                 **dragon),
            dict(kind="frame", name="prims_1x2", scene="dragon", mesh=(1, 2),
                 **dragon),
            dict(kind="sweep", name="prims_sweep", scene="dragon",
                 mesh=(1, 2), accel=True, side=EIGHTH_SIDE),
            dict(kind="frame", name="prims_brute_1x2", scene="standin",
                 mesh=(1, 2), **brute),
            dict(kind="sweep", name="prims_brute_sweep", scene="standin",
                 mesh=(1, 2), accel=False, side=EIGHTH_SIDE),
            dict(kind="train", name="train_2x1", scene="standin",
                 mesh=(2, 1)),
            dict(kind="train", name="train_1x2", scene="standin",
                 mesh=(1, 2))]),
        ("gloo, 4 ranks on one card", "gloo", 4, 300, [
            dict(kind="frame", name="grid_2x2", scene="standin", mesh=(2, 2),
                 features=HEADLINE, params={}, side=GRID_SIDE)]),
    )


def _rank_frame(job, scene, mesh, device, rank):
    """A sharded frame: the first with the launch counters and the
    collectives' counts reset around it (an NCCL communicator is set up in
    its first collective), then EIGHTH_FRAMES timed frames (host clock to
    a synchronize) with their collectives a frame; with job["single"]
    render_image of the same context in this process, bit for bit, and
    its frames timed alike, and the sharded frame with eager bounces
    (render.graphs._eager_bounces), bit for bit the one its bounces
    replayed from graphs, beside the graphs this rank holds."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch import parallel
    from cge_tpu_torch.parallel import comm
    from cge_tpu_torch.render import graphs

    feats = ct.Features(**job["features"])
    params = ct.RenderParams(**job["params"])
    side = job["side"]
    ctx = ct.prepare_render(scene, feats, params)

    def frame():
        return parallel.render_image_sharded(scene, ct.Camera(), feats,
                                             params, side, side, mesh,
                                             ctx=ctx)

    reset_launches()
    before = dict(comm.COLLECTIVES)
    t0 = time.perf_counter()
    img = frame()
    torch.cuda.synchronize()
    stats = dict(first_s=time.perf_counter() - t0, launches=read_launches(),
                 collectives={k: comm.COLLECTIVES[k] - before[k]
                              for k in before})
    def timed(fn):
        frames = []
        for _ in range(EIGHTH_FRAMES):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
        return frames

    before = dict(comm.COLLECTIVES)
    stats["frames_ms"] = timed(frame)
    stats["median_ms"] = float(np.median(stats["frames_ms"]))
    stats["collectives_frame"] = {
        k: (comm.COLLECTIVES[k] - before[k]) / EIGHTH_FRAMES for k in before}
    if ctx.accel is not None:
        stats["clusters"] = int(ctx.accel.perm.shape[0])
    if job.get("single"):
        cache = getattr(graphs._LOCAL, "cache", None)
        stats["graphs"] = 0 if cache is None else len(cache.graphs)
        with graphs._eager_bounces():
            stats["equal_eager"] = _same_frame(img, frame())
        ref = ct.render_image(scene, ct.Camera(), feats, params, side, side,
                              ctx=ctx)
        stats["equal_single"] = bool(
            torch.equal(torch.isnan(img), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(img), torch.nan_to_num(ref)))
        stats["single_ms"] = timed(lambda: ct.render_image(
            scene, ct.Camera(), feats, params, side, side, ctx=ctx))
    out = {job["name"]: img.cpu().numpy()} if rank == 0 else {}
    return stats, out


def _rank_sweep(job, scene, mesh, device, rank):
    """closest_hit over the frame's primary rays with the triangles sharded
    over 'prims' (K1 + K2 on this rank's clusters, or K3 on its rows)."""
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.ops import intersect
    from cge_tpu_torch.parallel import comm

    feats = ct.Features(**(HEADLINE if job["accel"] else BRUTE))
    ctx = ct.prepare_render(scene, feats, ct.RenderParams(**MAIN_PARAMS))
    o, d = camera_rays(job["side"], device)
    tmax = torch.full((o.shape[0],), torch.inf, device=device)
    reset_launches()
    with comm.bind_mesh(mesh):
        ids = intersect.closest_hit(scene, o, d, tmax, ctx.accel,
                                    tri_table=ctx.tri_table,
                                    shared_origin=True, sc_n=1,
                                    prims_axis="prims", perm_ids=True)
    torch.cuda.synchronize()
    axis = mesh.size(1)
    rows = (ctx.accel.perm.shape[0] if ctx.accel is not None
            else ctx.tri_table.shape[0])
    stats = dict(launches=read_launches(), slice=-(-rows // axis),
                 rows=int(rows),
                 unit="clusters" if ctx.accel is not None else "rows")
    out = ({f"{job['name']}/{k}": getattr(ids, k).cpu().numpy()
            for k in ("hit", "t", "prim")} if rank == 0 else {})
    return stats, out


def _rank_train(job, scene, mesh, device, rank, target):
    """loss_and_grads_sharded over TRAIN_SIDE^2 camera rays against the
    phase's target, then train_step_sharded; their ms (host clock)."""
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch import parallel
    from cge_tpu_torch.parallel import comm

    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    o, d = camera_rays(TRAIN_SIDE, device)
    reset_launches()
    before = dict(comm.COLLECTIVES)
    t0 = time.perf_counter()
    loss, grads = parallel.loss_and_grads_sharded(scene, o, d, target, feats,
                                                  params, mesh)
    torch.cuda.synchronize()
    stats = dict(grads_ms=(time.perf_counter() - t0) * 1e3,
                 launches=read_launches(),
                 collectives={k: comm.COLLECTIVES[k] - before[k]
                              for k in before})
    t0 = time.perf_counter()
    step_loss, new = parallel.train_step_sharded(scene, o, d, target, feats,
                                                 params, mesh, lr=TRAIN_LR)
    torch.cuda.synchronize()
    stats["step_ms"] = (time.perf_counter() - t0) * 1e3
    stats["step_loss"] = float(step_loss)
    out = {}
    if rank == 0:
        out[f"{job['name']}/loss"] = loss.cpu().numpy()
        out.update({f"{job['name']}/grad/{k}": g.cpu().numpy()
                    for k, g in grads.items()})
    return stats, out


def rank_main(spec_path: str) -> int:
    """One rank of a phase-14 world (run_ranks sets RANK, WORLD_SIZE and
    the env:// rendezvous): its jobs, its stats as rank{r}.json and, on
    rank 0, the arrays as arrays.npz in the spec's directory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import cge_tpu_torch as ct
    from cge_tpu_torch import parallel

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["WORLD_SIZE"])))
    backend = spec["backend"]
    index = rank % torch.cuda.device_count() if backend == "nccl" else 0
    torch.cuda.set_device(index)
    device = torch.device("cuda", index)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    parallel.init_distributed(backend, init_method="env://")
    scenes = {}

    def scene_of(name):
        if name not in scenes:
            scenes[name] = ct.load_scene_from_file(
                spec["objs"][name], [ct.PointLight(*LIGHT)], device=device)
        return scenes[name]

    stats, arrays = {}, {}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        if job["kind"] == "refuse":
            try:
                x = torch.ones(1, device=device)
                dist.all_reduce(x)
                torch.cuda.synchronize()
                st = dict(refused=False)
            except dist.DistBackendError as e:
                st = dict(refused=True, error=" | ".join(
                    ln.strip() for ln in str(e).splitlines()[:4]))
            out = {}
        else:
            mesh = parallel.make_mesh(("rays", "prims"), tuple(job["mesh"]))
            scene = scene_of(job["scene"])
            if job["kind"] == "frame":
                st, out = _rank_frame(job, scene, mesh, device, rank)
            elif job["kind"] == "sweep":
                st, out = _rank_sweep(job, scene, mesh, device, rank)
            else:
                target = torch.from_numpy(
                    np.load(spec["target"])["target"]).to(device)
                st, out = _rank_train(job, scene, mesh, device, rank, target)
        st["job_s"] = time.perf_counter() - t0
        stats[job["name"]] = st
        arrays.update(out)
    stats["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)
    if rank == 0:
        np.savez(os.path.join(spec["dir"], "arrays.npz"), **arrays)
    dist.destroy_process_group()
    return 0


def native_check(tmp, obj, dragon, tscene) -> dict:
    """The native library built anew with its flags (-Werror) on this
    machine; the dragon's OBJ loaded natively and by the numpy twin (the
    same sub-meshes and vertices, rtol 1e-6 / atol 1e-7, and the same
    triangles but for quads whose diagonals tie);
    the dragon's native cluster perm against the twin's (the scene's perm;
    same shape and cluster sizes, every triangle once; the clusters whose
    members differ, where a split plane cuts through equal centres,
    counted) and the stand-in's
    native reference BVH (median, SAH) against the twin's (levels,
    leaves, max per leaf, leaf spans)."""
    import numpy as np

    from cge_tpu_torch import native
    from cge_tpu_torch.ops import bvh
    from cge_tpu_torch.scene import mesh_io

    lib = native.build(build_dir=os.path.join(tmp, "native_build"))
    if sorted(lib.compiled) != sorted(native.SOURCES):
        raise AssertionError(f"the native build compiled {lib.compiled}, "
                             f"not its {len(native.SOURCES)} sources")
    row = dict(build_s=lib.build_seconds)
    t0 = time.perf_counter()
    subs = mesh_io.load_mesh(obj)
    row["load_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = mesh_io.load_mesh(obj, use_native=False)
    row["load_numpy_s"] = time.perf_counter() - t0
    if len(subs) != len(twin):
        raise AssertionError(f"native loader: {len(subs)} sub-meshes, "
                             f"numpy {len(twin)}")
    # the two split a quad whose diagonals tie to rounding apart (float32
    # against float64, ROADMAP section 3): the same vertices, and each
    # triangle pair that differs covers the same quad
    row["quads_apart"] = 0
    for a, b in zip(subs, twin):
        for k in ("positions", "normals", "texcoords"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        quads = np.unique(np.nonzero((a.triangles != b.triangles)
                                     .any(axis=1))[0] // 2)
        if not all(set(a.triangles[2 * q:2 * q + 2].ravel())
                   == set(b.triangles[2 * q:2 * q + 2].ravel())
                   for q in quads):
            raise AssertionError("native and numpy loads differ beyond "
                                 "the split of tied quads")
        row["quads_apart"] += len(quads)
    V, T, M = (x.cpu().numpy() for x in (dragon.vertices, dragon.tris,
                                         dragon.tri_mask))
    t0 = time.perf_counter()
    perm = bvh.build_clusters(V, T, M)
    row["clusters_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm_twin = bvh.build_clusters(V, T, M, use_native=False)
    row["clusters_numpy_s"] = time.perf_counter() - t0
    # the two partition ties at a split plane apart (nth_element against
    # argpartition): the same cluster sizes, every triangle once
    if (perm.shape != perm_twin.shape
            or not np.array_equal((perm >= 0).sum(1), (perm_twin >= 0).sum(1))
            or sorted(perm[perm >= 0].tolist()) != np.nonzero(M)[0].tolist()
            or not np.array_equal(perm, dragon.cluster_perm.cpu().numpy())):
        raise AssertionError("native cluster perm breaks the twin's "
                             "invariants")
    row["clusters_apart"] = sum(set(a) != set(b)
                                for a, b in zip(perm, perm_twin))
    for sah in (False, True):
        t0 = time.perf_counter()
        a = bvh.build_reference_bvh(tscene, sah_binning=sah)
        t1 = time.perf_counter()
        b = bvh.build_reference_bvh(tscene, sah_binning=sah, use_native=False)
        t2 = time.perf_counter()
        kind = "sah" if sah else "median"
        row[f"bvh_{kind}_native_ms"] = (t1 - t0) * 1e3
        row[f"bvh_{kind}_numpy_ms"] = (t2 - t1) * 1e3

        def spans(x):
            m = x.node_meta
            return sorted(map(tuple, m[m[:, 0] == 1][:, 2:4].tolist()))
        if ((a.num_levels, a.num_leaves, a.max_per_leaf)
                != (b.num_levels, b.num_leaves, b.max_per_leaf)
                or spans(a) != spans(b)):
            raise AssertionError(f"native {kind} BVH differs from the twin")
        row[f"bvh_{kind}"] = (a.num_levels, a.num_leaves, a.max_per_leaf)
    log(f"    native library: built in {row['build_s']:.2f} s, "
        f"{len(lib.compiled)} sources compiled in parallel, one object each "
        f"(the earlier single g++ call of every source: 21.08 s) (g++ "
        f"{' '.join(native.CXXFLAGS)}; {native.SOURCE_FLAGS}); dragon OBJ "
        f"load native "
        f"{row['load_native_s']:.2f} s, numpy {row['load_numpy_s']:.2f} s "
        f"({row['quads_apart']} tied quads split apart); "
        f"cluster perm ({perm.shape[0]} clusters, the scene's; "
        f"{row['clusters_apart']} hold other members, split-plane ties) "
        f"native "
        f"{row['clusters_native_s']:.2f} s, numpy "
        f"{row['clusters_numpy_s']:.2f} s; stand-in BVH median "
        f"{row['bvh_median']} native {row['bvh_median_native_ms']:.1f} ms, "
        f"numpy {row['bvh_median_numpy_ms']:.1f} ms; SAH {row['bvh_sah']} "
        f"native {row['bvh_sah_native_ms']:.1f} ms, numpy "
        f"{row['bvh_sah_numpy_ms']:.1f} ms; twins' invariants hold")
    return row


def _log_world(label, backend, wall, stats) -> None:
    log(f"    {label} ({backend}): wall {wall:.1f} s")
    for name in stats[0]:
        if name == "wall_s":
            continue
        for r, st in enumerate(stats):
            s = st[name]
            parts = [f"{name} rank {r}:"]
            if "launches" in s:
                parts.append("launches " + str({k: v for k, v in
                                                s["launches"].items() if v}))
            if "median_ms" in s:
                parts.append(f"first {s['first_s']:.2f} s, frames ms "
                             f"{[round(x, 2) for x in s['frames_ms']]}, "
                             f"median {s['median_ms']:.2f}")
            if "grads_ms" in s:
                parts.append(f"loss_and_grads {s['grads_ms']:.1f} ms, step "
                             f"{s['step_ms']:.1f} ms")
            if "collectives" in s:
                c = s["collectives"]
                parts.append(f"collectives {c['calls']} calls, "
                             f"{c['bytes']} B, {c['ms']:.2f} ms")
            if "collectives_frame" in s:
                c = s["collectives_frame"]
                parts.append(f"a timed frame's {c['calls']:.0f} calls, "
                             f"{c['bytes']:.0f} B, {c['ms']:.2f} ms")
            if "slice" in s:
                parts.append(f"its slice: {s['slice']} of {s['rows']} "
                             f"{s['unit']}")
            if "refused" in s:
                parts.append("NCCL refused: " + s.get("error", "")
                             if s["refused"] else "NCCL accepted")
            if "equal_eager" in s:
                parts.append(f"{s['graphs']} bounce graphs, equal to its "
                             f"eager bounces: {s['equal_eager']}")
            if "equal_single" in s:
                parts.append(f"equal to render_image: {s['equal_single']}, "
                             f"render_image frames ms "
                             f"{[round(x, 2) for x in s['single_ms']]}")
            log(f"      {parts[0]} {', '.join(parts[1:])}")


def _need_launches(ranks, name, kernels, absent) -> None:
    """Every rank of the run launched each of kernels and none of absent."""
    for r, st in enumerate(ranks):
        got = st["launches"]
        if any(got[k] <= 0 for k in kernels) or any(got[k] for k in absent):
            raise AssertionError(f"{name} rank {r} launches {got}")


def run_world(tmp, label, backend, world, timeout, jobs, shared) -> tuple:
    """One world of rank processes of this script over `jobs`; `shared`:
    the spec's target and objs. Returns ({job: [each rank's stats]},
    rank 0's arrays, wall s) and logs every rank's stats."""
    import numpy as np

    from cge_tpu_torch.parallel.launch import run_ranks

    wdir = tempfile.mkdtemp(prefix=f"world_{backend}_{world}_", dir=tmp)
    spec = os.path.join(wdir, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(backend=backend, dir=wdir, jobs=jobs, **shared), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    run_ranks([sys.executable, os.path.abspath(__file__), "--rank", spec],
              world, timeout, env=env, cwd=REPO)
    wall = time.perf_counter() - t0
    stats = []
    for r in range(world):
        with open(os.path.join(wdir, f"rank{r}.json")) as f:
            stats.append(json.load(f))
    _log_world(label, backend, wall, stats)
    results = {name: [st[name] for st in stats]
               for name in stats[0] if name != "wall_s"}
    return results, dict(np.load(os.path.join(wdir, "arrays.npz"))), wall


def _shared_inputs(tmp, obj, tobj) -> dict:
    """The train steps' seeded target (saved for the ranks) and the OBJs."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    target = rng.uniform(0.0, 0.5, (TRAIN_SIDE ** 2, 3)).astype(np.float32)
    path = os.path.join(tmp, "eighth_target.npz")
    np.savez(path, target=target)
    return dict(target=path, objs=dict(dragon=obj, standin=tobj))


def check_exact(img, ref, what) -> str:
    import numpy as np

    if not (np.array_equal(np.isnan(img), np.isnan(ref))
            and np.array_equal(np.nan_to_num(img), np.nan_to_num(ref))):
        raise AssertionError(f"{what} differs from render_image")
    return f"{what} equal to render_image bit for bit"


def check_image(img, ref, what) -> str:
    nan_agree, frac = compare_images(img, ref)
    if nan_agree < 0.999 or frac < 0.995:
        raise AssertionError(f"{what} differs from render_image")
    return f"{what} NaN agree {nan_agree:.5f}, {frac:.4%} close"


def check_prims_sweep(arrays, name, scene, c, device) -> str:
    """A prims-sharded sweep's primary rays against the single-device
    sweep: hits and t equal, ids off exact-t ties."""
    import numpy as np
    import torch

    from cge_tpu_torch.ops import intersect

    o, d = camera_rays(EIGHTH_SIDE, device)
    tmax = torch.full((o.shape[0],), torch.inf, device=device)
    one = intersect.closest_hit(scene, o, d, tmax, c.accel,
                                tri_table=c.tri_table, shared_origin=True,
                                sc_n=1, perm_ids=True)
    hit, t, prim = (arrays[f"{name}/{k}"] for k in ("hit", "t", "prim"))
    if not (np.array_equal(hit, one.hit.cpu().numpy())
            and np.array_equal(t, one.t.cpu().numpy())):
        raise AssertionError(f"{name}: hits or t differ from the "
                             f"single-device sweep")
    apart = int((prim != one.prim.cpu().numpy())[hit].sum())
    if apart > 1e-3 * hit.sum():
        raise AssertionError(f"{name}: {apart} ids apart")
    return (f"{name}: {int(hit.sum())} hits and t equal to the "
            f"single-device sweep, {apart} ids apart (exact-t ties)")


def check_train(arrays, names, tscene, shared, device) -> list:
    """The sharded steps' loss and gradients against loss_and_grads on
    the same rays and target: TRAIN_LOSS_REL, TRAIN_GRAD_REL."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct

    target = torch.from_numpy(np.load(shared["target"])["target"])
    o, d = camera_rays(TRAIN_SIDE, device)
    loss, grads = ct.loss_and_grads(tscene, o, d, target.to(device),
                                    ct.Features(**BRUTE), ct.RenderParams())
    lines = []
    for name in names:
        gl = float(arrays[f"{name}/loss"])
        rel = {k: float(np.linalg.norm(arrays[f"{name}/grad/{k}"]
                                       - g.cpu().numpy())
                        / np.linalg.norm(g.cpu().numpy()))
               for k, g in grads.items() if float(g.norm()) > 0}
        worst = max(rel, key=rel.get)
        lines.append(f"{name}: loss {gl:.8g} against {float(loss):.8g}, "
                     f"worst gradient {worst} at {rel[worst]:.3g} of its "
                     f"norm")
        if (abs(gl - float(loss)) > TRAIN_LOSS_REL * abs(float(loss))
                or rel[worst] > TRAIN_GRAD_REL):
            raise AssertionError(f"{name} differs from the single step")
    return lines


def eighth_path(tmp, obj, tobj, dragon, ctx, tscene, tctx, device) -> dict:
    """Phase 14: the sharded entry points in worlds of rank processes on
    the one card, each result held to the single-device path here, and
    the native library's build, load and builders."""
    import cge_tpu_torch as ct

    log(f"[14] eighth path: multi-device on one card (torch.distributed) "
        f"and the native host library | {SMI['line']}")
    nat = native_check(tmp, obj, dragon, tscene)
    shared = _shared_inputs(tmp, obj, tobj)
    results, arrays = {}, {}
    for label, backend, world, timeout, jobs in eighth_worlds():
        res, arr, wall = run_world(tmp, label, backend, world, timeout, jobs,
                                   shared)
        results.update(res)
        results[f"{label}/wall_s"] = wall
        arrays.update(arr)

    accel_runs = ("nccl_1x1", "rays_2x1", "prims_1x2", "prims_sweep",
                  "grid_2x2")
    for name in accel_runs:
        _need_launches(results[name], name, ("keys", "walk"), ("sweep",))
    for name in ("prims_brute_1x2", "prims_brute_sweep", "train_2x1",
                 "train_1x2"):
        _need_launches(results[name], name, ("sweep",), ("keys", "walk"))
    # (a) the NCCL world of one: render_image's frame in the same process
    one = results["nccl_1x1"][0]
    if not (one["equal_single"] and one["equal_eager"] and one["graphs"]):
        raise AssertionError("the NCCL sharded frame differs from "
                             "render_image or its eager bounces, or "
                             "replayed no graph")
    # (b) gloo, two ranks: rays = 2 bit for bit, prims = 2 under the image
    # rule, every rank through its kernels on its own slice
    feats, params = ct.Features(**HEADLINE), ct.RenderParams(**MAIN_PARAMS)
    ref = ct.render_image(dragon, ct.Camera(), feats, params, EIGHTH_SIDE,
                          EIGHTH_SIDE, ctx=ctx).cpu().numpy()
    bref = ct.render_image(tscene, ct.Camera(), ct.Features(**BRUTE),
                           ct.RenderParams(), EIGHTH_SIDE, EIGHTH_SIDE,
                           ctx=tctx).cpu().numpy()
    checks = [check_exact(arrays["rays_2x1"], ref, "rays = 2 frame"),
              check_image(arrays["prims_1x2"], ref, "prims = 2 frame"),
              check_prims_sweep(arrays, "prims_sweep", dragon, ctx,
                                device),
              check_prims_sweep(arrays, "prims_brute_sweep", tscene, tctx,
                                device),
              check_image(arrays["prims_brute_1x2"], bref,
                          "prims = 2 accel-off frame")]
    checks += check_train(arrays, ("train_2x1", "train_1x2"), tscene,
                          shared, device)
    # (c) four ranks, rays x prims = 2 x 2
    gref = ct.render_image(tscene, ct.Camera(), feats, ct.RenderParams(),
                           GRID_SIDE, GRID_SIDE).cpu().numpy()
    checks.append(check_image(arrays["grid_2x2"], gref, "2 x 2 frame"))
    checks.append("NCCL with 2 ranks on one card: " + (
        "refused" if all(s["refused"] for s in results["nccl_refuse"])
        else "accepted"))
    for line in checks:
        log("    " + line)
    return dict(native=nat, worlds=results)


# ---------------------------------------------------------------------------
# phase 15: the compiled library's cases, the primitives, frame attribution
# ---------------------------------------------------------------------------

PROFILE_FRAMES = 3
# (row, frame_profile's scene, its kernels: (name in the trace, counter))
PROFILE_ROWS = (
    ("scale512", "dragon", (("block_entry_keys_kernel", "keys"),
                            ("cluster_walk_split_kernel", "walk"))),
    ("brute512", "brute", (("closest_tris_sweep_kernel", "sweep"),)),
)


def oracle_replay(device) -> None:
    """The compiled library's 4,096 triangle cases through K3 (a one-row
    table a case, a call each) and through K1, the sort and K2 (a
    one-triangle cluster a case, all in one sweep: golden_replay.
    walk_cases_batched) in both tile layouts: t and ids equal to the
    twins' on the card, and at least 99.9% of decisions agreeing with the
    library; then
    every primitive on every case on the card and on the CPU, bit for bit
    (cge_tpu_torch/tools/golden_replay.py)."""
    import torch

    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.tools import golden_replay as gr

    g = gr.load(device=device)
    tri = g["tri"]
    runs = [("K3", lambda plain: gr.sweep_cases(tri, plain))]
    runs += [(f"K1 + sort + K2 ({layout} layout)",
              lambda plain, layout=layout: gr.walk_cases_batched(
                  tri, layout, plain)) for layout in cs.LAYOUTS]
    for name, fn in runs:
        t0 = time.perf_counter()
        got = fn(False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = fn(True)
        t2 = time.perf_counter()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} differs from its twin on the "
                                 f"library's cases")
        hit = torch.isfinite(got[0])
        agree, dt = gr.agreement(hit, got[0], tri["hit"], tri["t"])
        if agree < 0.999:
            raise AssertionError(f"{name} agrees with the library on "
                                 f"{agree:.5f} of its decisions")
        log(f"    {name} on the library's {gr.N} triangle cases: t and ids "
            f"equal to the twins' on the card; "
            f"{int((hit == tri['hit']).sum())} of {gr.N} decisions agree "
            f"with the library, |dt| <= {dt:.3g} on the "
            f"{int((hit & tri['hit']).sum())} both hit; kernels "
            f"{t1 - t0:.1f} s, twins {t2 - t1:.1f} s")
    card = gr.primitives(g)
    cpu = gr.primitives(gr.load())
    apart = [k for k, v in card.items() if not gr.same(v.cpu(), cpu[k])]
    if apart:
        raise AssertionError(f"the card's primitives differ from the CPU's "
                             f"on {apart}")
    pln = g["pln"]
    decisions = {
        "triangle": (torch.isfinite(card["tri_t"]), tri["hit"]),
        "sphere": (torch.isfinite(card["sph_t"]), g["sph"]["hit"]),
        "box": (card["box_hit"], g["box"]["hit"]),
        "plane": ((card["pln_t"] >= 0) & (card["pln_t"] <= pln["tmax"]),
                  pln["hit"]),
        "point in triangle": (card["pln_inside"], pln["inside"])}
    shares = {k: float((a == b).float().mean())
              for k, (a, b) in decisions.items()}
    log(f"    the primitives on every case ({', '.join(card)}): the card's "
        f"equal to the CPU's bit for bit; decisions agreeing with the "
        f"library: " + ", ".join(f"{k} {v:.5f}" for k, v in shares.items()))


def frame_attribution(scenes, device) -> dict:
    """cge_tpu_torch/tools/frame_profile.py on scale512 and brute512 with
    the contexts of phases 3 and 5, PROFILE_FRAMES profiled frames each:
    the profiler's count of each kernel equal to its launch counter over
    the same frames (a trace that misses one is taken again, up to
    fp.TRACE_TAKES traces), device-op ms within the wall, the busy share
    and the top ops."""
    import cge_tpu_torch as ct
    from cge_tpu_torch.tools import frame_profile as fp

    out = {}
    for row, name, kernels in PROFILE_ROWS:
        scene, ctx = scenes[name]
        _, feats, params = fp.SCENES[name]
        for take in range(1, fp.TRACE_TAKES + 1):
            s = fp.profile_frames(scene, ct.Features(**feats),
                                  ct.RenderParams(**params), W,
                                  PROFILE_FRAMES, ctx=ctx)
            counts = {k: fp.kernel_count(s, kname) for kname, k in kernels}
            if any(not s["launches"][k] for k in counts):
                raise AssertionError(f"{row}: launches {s['launches']}")
            if all(n == s["launches"][k] for k, n in counts.items()):
                break
            miss = (f"{row}: the profiler counted {counts}, the launch "
                    f"counters {s['launches']}")
            if take == fp.TRACE_TAKES:
                raise AssertionError(f"{miss}, in each of {take} traces")
            log(f"  {miss}: traced again, this trace's readings unused")
        if s["device_ms"] > s["wall_ms"]:
            raise AssertionError(f"{row}: {s['device_ms']:.2f} device-op "
                                 f"ms a frame past the wall's "
                                 f"{s['wall_ms']:.2f}")
        log(f"  {row}: the profiler's kernels {counts} equal the launch "
            f"counters over {PROFILE_FRAMES} frames")
        for line in fp.report(dict(s, title=f"{row} {W}x{H}"), 12):
            log("    " + line)
        out[row] = s
    return out


def ninth_path(dragon, ctx, tscene, tctx, device) -> dict:
    """Phase 15; dragon, ctx and tscene, tctx: phase 3's and phase 5's
    scenes and contexts."""
    log(f"[15] ninth path: the compiled intersection library's cases on the "
        f"card, the primitives on the card and the CPU, the per-op frame "
        f"attribution | {SMI['line']}")
    reset_launches()
    oracle_replay(device)
    rows = frame_attribution({"dragon": (dragon, ctx),
                              "brute": (tscene, tctx)}, device)
    launches = read_launches()
    if any(launches[k] <= 0 for k in ("keys", "walk", "sweep")):
        raise AssertionError(f"phase 15 launched {launches}")
    log(f"  phase 15 launches {launches}")
    return rows


# ---------------------------------------------------------------------------
# phase 16: the benchmark's cells (bench_torch/)
# ---------------------------------------------------------------------------

def tenth_path(device) -> dict:
    """Phase 16: the benchmark's five cells (bench_torch/cells.py), in
    BENCHMARK.json's order, once each through bench_torch/bench.py's
    run_cell: one warm-up and one timed call, the output against its
    reference (tools/oracle/oracle in the same run for scale512,
    transrec512 and brute512; the stored JAX references for soft512 and
    train128), and one traced call whose kernel counts must equal the
    launch counters. A cell that fails its check fails the phase. run_cell
    sets the counters to 0 before each cell's timed call and reads them
    after it (`launches_per_call`), and the traced call reads them again
    (run_cell raises unless a cell launched its own kernels and no
    other)."""
    from bench_torch import bench
    from bench_torch import cells as bc

    log(f"[16] tenth path: the benchmark's cells once each (bench_torch/) "
        f"| {SMI['line']}")
    with tempfile.TemporaryDirectory() as tmp:
        rows = {cell.name: bench.run_cell(
            cell, device, tmp, frames=1, warmup=1, profile_frames=1,
            log=lambda m: log("  " + m)) for cell in bc.CELLS}
    bad = [name for name, r in rows.items() if not r["correct"]]
    if bad:
        raise AssertionError(f"benchmark cells failed their checks: {bad}")
    launches = {name: {k: v for k, v in r["launches_per_call"].items() if v}
                for name, r in rows.items()}
    if not all(any(c.get(k) for c in launches.values())
               for k in ("keys", "walk", "sweep")):
        raise AssertionError(f"phase 16 launched {launches}")
    log(f"  phase 16 launches a call, by cell: {launches}")
    return rows


# ---------------------------------------------------------------------------
# phase 17: each bounce as a CUDA graph replay, against the eager bounce
# ---------------------------------------------------------------------------

# the benchmark's frame cells whose bounces replay as graphs (train128's
# step runs under autograd: eager)
GRAPH_CELLS = ("scale512", "brute512", "soft512", "transrec512")
# frames a timed turn; the turns run eager, graphs, graphs, eager
GRAPH_TURN_FRAMES = 3
# phase 17's camera batches, cameras a cell (soft512's draws from a new
# key a camera)
GRAPH_BATCHES = {"scale512": 4, "transrec512": 4, "soft512": 16}


def _same_frame(a, b) -> bool:
    """torch.equal on the float frames, with equal NaN masks."""
    import torch

    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0.0, a),
                            torch.where(b.isnan(), 0.0, b)))


def graphs_row(label, scene, feats, params, side, seed) -> dict:
    """One row of phase 17, from one prepared context: the eager frame
    (render.graphs._eager_bounces) before any graph exists, then two frames
    through the graphs (the first warms up each bounce's signature on its
    first chunk and captures it on the second, the second only replays),
    each equal to the eager frame bit for bit with the same launches; the
    peak allocated and reserved memory of each; then the frames timed in
    turns, eager, graphs, graphs, eager, GRAPH_TURN_FRAMES each, every
    graph frame held to the eager one again."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.render import graphs

    ctx = ct.prepare_render(scene, feats, params)

    def frame():
        before = graphs.launch_counts()
        t0 = time.perf_counter()
        img = ct.render_image(scene, ct.Camera(), feats, params, side, side,
                              seed, ctx=ctx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return img, ms, graphs.launches_between(before,
                                                graphs.launch_counts())

    def peak():
        return (torch.cuda.max_memory_allocated() / 2**20,
                torch.cuda.max_memory_reserved() / 2**20)

    torch.cuda.reset_peak_memory_stats()
    with graphs._eager_bounces():
        want, first_ms, want_n = frame()
    eager_peak = peak()
    torch.cuda.reset_peak_memory_stats()
    warm = [frame() for _ in range(2)]
    graph_peak = peak()
    n_graphs = len(graphs._LOCAL.cache.graphs)

    def held(img, n, what):
        if not _same_frame(img, want) or n != want_n:
            raise AssertionError(f"{label}: the {what} frame differs from "
                                 f"the eager frame (launches {n} against "
                                 f"{want_n})")

    for i, (img, _, n) in enumerate(warm):
        held(img, n, ("capturing", "replayed")[i])
    turns = {"eager": [], "graphs": []}
    for kind in ("eager", "graphs", "graphs", "eager"):
        ctxm = (graphs._eager_bounces() if kind == "eager"
                else contextlib.nullcontext())
        with ctxm:
            for _ in range(GRAPH_TURN_FRAMES):
                img, ms, n = frame()
                held(img, n, kind)
                turns[kind].append(ms)
    eager_ms = float(np.median(turns["eager"]))
    graph_ms = float(np.median(turns["graphs"]))
    row = dict(label=label, eager_ms=turns["eager"],
               graph_ms=turns["graphs"], first_eager_ms=first_ms,
               warm_ms=[w[1] for w in warm], graphs=n_graphs,
               launches={k: v for m in want_n for k, v in m.items()},
               eager_peak_mib=eager_peak, graph_peak_mib=graph_peak)
    log(f"  {label}: {n_graphs} graphs; frames equal to the eager frame "
        f"bit for bit, launches {row['launches']} a frame; host ms a frame, "
        f"eager {[round(x, 2) for x in turns['eager']]} (median "
        f"{eager_ms:.2f}), graphs {[round(x, 2) for x in turns['graphs']]} "
        f"(median {graph_ms:.2f}), {eager_ms / graph_ms:.2f}x; the capturing "
        f"frame {warm[0][1]:.1f} ms; peak MiB allocated / reserved: eager "
        f"{eager_peak[0]:.0f} / {eager_peak[1]:.0f}, with the graphs "
        f"{graph_peak[0]:.0f} / {graph_peak[1]:.0f}")
    return row


def graphs_batch(label, scene, feats, params, side, seed, cameras) -> dict:
    """A camera batch of phase 17: render_images over `cameras` cameras
    (camera i with seed + i) from a fresh context, with eager bounces (the
    parent's path) and then through the graphs after one camera alone, the
    frames equal bit for bit; the peak allocated and reserved MiB of each
    run (the allocator's cache emptied before it); the graphs the context
    holds after the first camera and after the batch, its entries at most
    render.graphs.MAX_ENTRIES, and no capture after the first camera: the
    cameras' keys, where the bounces draw samples, are graph inputs."""
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.render import graphs, lights

    cams = [ct.Camera(rotation=(20.0, 20.0 + 10.0 * i, 0.0))
            for i in range(cameras)]
    ctx = ct.prepare_render(scene, feats, params)

    def run(batch):
        t0 = time.perf_counter()
        imgs = ct.render_images(scene, batch, feats, params, side, side,
                                seed, ctx=ctx)
        torch.cuda.synchronize()
        return imgs, (time.perf_counter() - t0) * 1e3

    def measured(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        return out, (torch.cuda.max_memory_allocated() / 2**20,
                     torch.cuda.max_memory_reserved() / 2**20)

    with graphs._eager_bounces():
        (want, eager_ms), eager_peak = measured(lambda: run(cams))

    def graphed():
        run(cams[:1])
        first = len(graphs._LOCAL.cache.graphs)
        imgs, ms = run(cams)
        cache = graphs._LOCAL.cache
        return imgs, ms, first, len(cache.graphs), len(cache.entries)

    (got, graph_ms, first, n_graphs, n_entries), graph_peak = measured(
        graphed)
    for i in range(cameras):
        if not _same_frame(got[i], want[i]):
            raise AssertionError(f"{label} batch: camera {i}'s graph frame "
                                 f"differs from the eager frame")
    sampled = lights.draws_samples(scene, feats)
    if n_entries > graphs.MAX_ENTRIES or n_graphs != first:
        raise AssertionError(f"{label} batch: {n_entries} entries, graphs "
                             f"{first} after one camera, {n_graphs} after "
                             f"{cameras}")
    row = dict(label=label, cameras=cameras, sampled=sampled,
               eager_ms=eager_ms, graph_ms=graph_ms, graphs_first=first,
               graphs=n_graphs, entries=n_entries, eager_peak_mib=eager_peak,
               graph_peak_mib=graph_peak)
    log(f"  {label} batch of {cameras} cameras (seeds {seed}..."
        f"{seed + cameras - 1}; samples drawn: {sampled}): frames equal to "
        f"the eager frames; graphs {first} after one camera, {n_graphs} "
        f"after the batch, {n_entries} entries (bound {graphs.MAX_ENTRIES}); "
        f"host ms eager {eager_ms:.1f}, graphs {graph_ms:.1f}; peak MiB "
        f"allocated / reserved: eager {eager_peak[0]:.0f} / "
        f"{eager_peak[1]:.0f}, graphs (one camera, then the batch) "
        f"{graph_peak[0]:.0f} / {graph_peak[1]:.0f}")
    return row


def graphs_path(device) -> dict:
    """Phase 17: the frame cells of the benchmark (GRAPH_CELLS), each at
    its own scene, features, params, size and seed, with their bounces
    replayed from CUDA graphs against the eager bounces (graphs_row); then
    the camera batches of GRAPH_BATCHES (graphs_batch); then the two paths
    no other phase runs through the graphs: the stand-in textured
    (bilinear, phase 11's scene) and glossy256 with the accel (phase
    12's), whose first bounce's outputs outlive its level."""
    import cge_tpu_torch as ct
    from bench_torch import cells as bc
    from cge_tpu_torch.tools.common import (write_textured_obj,
                                            write_variant_obj)

    log(f"[17] graphs: the bounces of {', '.join(GRAPH_CELLS)}, a textured "
        f"and a glossy frame replayed from CUDA graphs against the eager "
        f"bounces | {SMI['line']}")
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in GRAPH_CELLS:
            cell = bc.BY_NAME[name]
            obj = bc.obj_path(cell, tmp)
            bc.write_scene(cell, obj)
            scene = bc.load(cell, obj, device)
            args = (scene, ct.Features(**cell.features),
                    ct.RenderParams(**cell.params), cell.side, cell.seed)
            rows[name] = graphs_row(name, *args)
            if name in GRAPH_BATCHES:
                rows[f"{name}-batch"] = graphs_batch(name, *args,
                                                     GRAPH_BATCHES[name])
            del scene, args
        light = [ct.PointLight(*LIGHT)]
        tex = os.path.join(tmp, "standin_tex.obj")
        write_textured_obj(tex, *TEAPOT_GRID, tex_hw=TEX_HW, seed=SEED)
        rows["tex512"] = graphs_row(
            "tex512 (bilinear)", ct.load_scene_from_file(tex, light,
                                                         device=device),
            ct.Features(**BRUTE, enable_texture_mapping=True,
                        enable_bilinear_texture_filtering=True),
            ct.RenderParams(), W, FIFTH_SEED)
        glossy = os.path.join(tmp, "standin_glossy.obj")
        write_variant_obj(glossy, *TEAPOT_GRID, "glossy")
        rows["glossy256"] = graphs_row(
            "glossy256 (accel on)", ct.load_scene_from_file(
                glossy, light, device=device),
            ct.Features(**GLOSSY, enable_accel_structure=True),
            ct.RenderParams(**GLOSSY_PARAMS), 256, FIFTH_SEED)
    return rows


# ---------------------------------------------------------------------------
# phase 18: textures decoded without Pillow
# ---------------------------------------------------------------------------

TEXTURES = os.path.join(REPO, "tests", "torch_textures")
# the 1024x1024 progressive 4:2:0 JPEG the textured dragon wears
TEX_JPEG = "jpeg_progressive_420_q90_1024.jpg"
# its texels as a lossy WebP at quality 90, and their top-left corner as a
# lossless one (jax_references/make_textures.py)
TEX_WEBP = "webp_lossy_q90_1024.webp"
WEBP_CROP = 256
TEX_WEBP_CROP = f"webp_lossless_crop{WEBP_CROP}.webp"
# the texels' 256x256 crop as an arithmetic-coded progressive YCCK JPEG at
# 4:4:0 whose scans leave a coefficient unrefined (block smoothing):
# make_textures.JPEG_CROP_NAME
TEX_JPEG_CROP = "jpeg_ycck_440_arith_progressive_smoothed_256.jpg"
# the JPEG fixtures of the variants Pillow does not write, by kind (name
# prefixes), for phase 18a's decode times
JPEG_VARIANT_KINDS = (
    ("sampling", ("jpeg_sampling_",)), ("CMYK / YCCK", ("jpeg_cmyk_",
                                                        "jpeg_ycck")),
    ("arithmetic", ("jpeg_arith_",)),
    ("smoothed", ("jpeg_smooth_", "jpeg_arith_smooth_")),
    ("lossless", ("jpeg_lossless_",)))
# the texels as a tiled YCbCr 2x2 JPEG-in-TIFF at quality 85
TEX_TIFF_JPEG = "tiff_jpeg_ycbcr22_tiles_q85_1024.tif"
# the texels as JPEG 2000 (jax_references/make_textures.j2k_chip_files),
# with a manifest of their own: their top-left 512x512 crop as a lossless
# J2K codestream (5/3, RCT, RPCL, 256x256 tiles, SOP / EPH), the texels as
# a lossy JP2 (9/7, ICT, three quality layers, 32x32 code-blocks) and an
# ICNS whose ic10 entry is that JP2
TEX_J2K_DIR = os.path.join(TEXTURES, "j2k_chip")
J2K_CROP = 512
TEX_J2K = f"j2k_lossless_rpcl_tiles256_crop{J2K_CROP}.j2k"
TEX_JP2 = "jp2_lossy_97_3layers_cb32_1024.jp2"
TEX_ICNS = "icns_ic10_jp2_1024.icns"
# small files of TIFF's, PSD's and JPEG 2000's tail (make_textures
# tail_fixtures), and the chip path's files of the texels with a manifest of
# their own (make_textures.tail_chip_files): their 512x512 crop as a
# Deflate CIE L*a*b* TIFF, a lossy JP2 with Part 2 MCT / MCC / MCO markers,
# an old-style JPEG TIFF
TEX_TAIL_DIR = os.path.join(TEXTURES, "pillow_tail")
TEX_TAIL_CHIP_DIR = os.path.join(TEXTURES, "tail_chip")
LAB_CROP = 512
TEX_LAB = f"tiff_lab_deflate_pred2_crop{LAB_CROP}.tif"
TEX_MCT = "jp2_part2_mct_offsets_97_1024.jp2"
TEX_OJPEG = "tiff_ojpeg_ycbcr22_jif_strips_q85_1024.tif"
# small files of Pillow's other PNM modes, XBM and XPM, and the damaged
# files the port once parted from Pillow on and now decodes as it does
# (make_textures.x11_pnm_fixtures, fault_fixtures), with a manifest of
# their own: phase 18a's decode times by kind
TEX_X11_DIR = os.path.join(TEXTURES, "x11_pnm")
# the crops phase 18c writes as the text formats
X11_CROP = 256
XPM_RGB_CROP = 96
# small files of GIMP brushes, FLI / FLC, Windows Paint, Kodak PhotoCD,
# PIXAR and XV thumbnails (make_textures.legacy_fixtures), those JAX's
# loader refuses listed without a hash, with a manifest of their own: phase
# 18a's decode times by kind; its PCD of the texels in orientation 0 (their
# PhotoYCC samples: Y the green of the top-left 768x512, C1 and C2 the
# blue and red of every other texel) is phase 18c's PCD row
TEX_LEGACY_DIR = os.path.join(TEXTURES, "legacy")
TEX_PCD = "pcd_texels_o0.pcd"
# small FITS, McIdas, SPIDER, IM, IM Tools and IPTC files
# (make_textures.science_fixtures), those JAX's loader refuses listed
# without a hash, with a manifest of their own: phase 18a's decode times by
# kind; its IPTC stream of the texels' 256x256 crop's green as a grey JPEG
# in band 2 of RGB is phase 18c's IPTC JPEG row
TEX_SCIENCE_DIR = os.path.join(TEXTURES, "science")
TEX_IPTC_JPEG = "iptc_jpeg_band2_crop256.iim"
# the tail's fixtures by kind (name prefixes), for phase 18a's decode times
TAIL_KINDS = (
    ("old-style JPEG", ("tiff_ojpeg_",)),
    ("ThunderScan", ("tiff_thunderscan_",)),
    ("JPEG YCbCr planes", ("tiff_jpeg_ycbcr_planes",)),
    ("Lab", ("tiff_lab_", "psd_lab_")),
    ("JPEG 2000 Part 2", ("j2k_part2_", "jp2_part2_")))


def texture_fixtures() -> list:
    """Phase 18a: each fixture (tests/torch_textures/ and its j2k_chip/,
    pillow_tail/, tail_chip/, x11_pnm/, legacy/ and science/) through the
    port's
    load_image, its u8 pixels' SHA-256 against its manifest's, or, where
    the manifest has no hash (JAX's loader refuses the file), a ValueError
    naming the file; (name, kind, host ms) a fixture."""
    import hashlib

    import numpy as np

    from cge_tpu_torch.scene import image_io

    entries = []
    for folder in (TEXTURES, TEX_J2K_DIR, TEX_TAIL_DIR, TEX_TAIL_CHIP_DIR,
                   TEX_X11_DIR, TEX_LEGACY_DIR, TEX_SCIENCE_DIR):
        with open(os.path.join(folder, "manifest.json")) as f:
            entries += [(folder, e) for e in json.load(f)["files"]]
    times, bad = [], []
    for folder, entry in entries:
        path = os.path.join(folder, entry["name"])
        t0 = time.perf_counter()
        if entry["sha256"] is None:
            try:
                image_io.load_image(path)
            except ValueError as e:
                if path not in str(e):
                    bad.append(f"{entry['name']} (refused without its "
                               f"name)")
            else:
                bad.append(f"{entry['name']} (decoded; JAX refuses it)")
            times.append((entry["name"], entry["kind"],
                          (time.perf_counter() - t0) * 1e3))
            continue
        img = image_io.load_image(path)
        ms = (time.perf_counter() - t0) * 1e3
        u8 = np.rint(img.pixels * 255.0).astype(np.uint8)
        if hashlib.sha256(u8.tobytes()).hexdigest() != entry["sha256"]:
            bad.append(entry["name"])
        times.append((entry["name"], entry["kind"], ms))
    if "PIL" in sys.modules:
        raise AssertionError("decoding the textures imported Pillow")
    if bad:
        raise AssertionError(f"decoded textures differ from the manifest: "
                             f"{bad}")
    return times


def rgb332(texels):
    """The 3-3-2 colour indices [H, W] uint8 of the texels [H, W, 3] u8
    (red's top three bits first) and the 256-colour palette [256, 3] they
    index: the GIF's, BLP's, XPM's, FLC's and XV thumbnail's."""
    import numpy as np

    idx = ((texels[..., 0] >> 5) << 5 | (texels[..., 1] >> 5) << 2
           | texels[..., 2] >> 6).astype(np.uint8)
    i = np.arange(256)
    palette = np.stack([(i >> 5 & 7) * 255 // 7, (i >> 2 & 7) * 255 // 7,
                        (i & 3) * 255 // 3], axis=1).astype(np.uint8)
    return idx, palette


def texture_writers(texels):
    """Phase 18c's files of the texels [H, W, 3] u8 (row 0 the top):
    {name: (file bytes, the texels the file holds)}, each written by a
    plain numpy writer, none by the port."""
    import struct

    import numpy as np

    h, w = texels.shape[:2]
    out = {"texels.ppm": (b"P6\n%d %d\n255\n" % (w, h) + texels.tobytes(),
                          texels)}
    # TGA type 10, top-left: literal packets of 100 pixels, across rows
    bgr = texels[..., ::-1].reshape(-1, 3)
    n, k = len(bgr), 100
    full = n // k
    body = np.concatenate([np.full((full, 1), k - 1, np.uint8),
                           bgr[:full * k].reshape(full, 3 * k)], axis=1)
    tail = bgr[full * k:]
    tga = (struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24,
                       0x20) + body.tobytes()
           + (bytes((len(tail) - 1,)) + tail.tobytes() if len(tail) else b""))
    out["texels.tga"] = (tga, texels)
    # PSD RGB, PackBits: every row eight literal packets of w / 8 bytes
    planes = np.moveaxis(texels, 2, 0)
    step = w // 8
    packed = np.concatenate([np.full((3, h, 8, 1), step - 1, np.uint8),
                             planes.reshape(3, h, 8, step)], axis=3)
    psd = (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, h, w, 8, 3)
           + bytes(12) + struct.pack(">H", 1)
           + np.full(3 * h, 8 * (step + 1), ">u2").tobytes()
           + packed.tobytes())
    out["texels.psd"] = (psd, texels)
    # GIF: 3-3-2 colours, LZW at 9 bits (a clear code every 254 codes)
    idx, palette = rgb332(texels)
    idx = idx.reshape(-1).astype(np.uint32)
    codes = np.concatenate(
        [np.concatenate(([256], idx[j:j + 254])) for j in range(
            0, len(idx), 254)] + [np.array([257], np.uint32)])
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint32)) & 1).astype(
        np.uint8)
    lzw = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes((len(lzw[j:j + 255]),)) + lzw[j:j + 255]
                      for j in range(0, len(lzw), 255))
    gif = (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
           + palette.tobytes() + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
           + b"\x08" + blocks + b"\x00;")
    out["texels.gif"] = (gif, palette[idx.reshape(h, w)])
    out.update(tiff_writers(texels))
    out.update(dds_writers(texels))
    out.update(asset_writers(texels))
    out.update(x11_writers(texels))
    out.update(legacy_writers(texels))
    out.update(science_writers(texels))
    for name in (TEX_WEBP, TEX_WEBP_CROP, TEX_TIFF_JPEG, TEX_JPEG_CROP):
        with open(os.path.join(TEXTURES, name), "rb") as f:
            data = f.read()
        if name == TEX_WEBP_CROP:
            held = texels[:WEBP_CROP, :WEBP_CROP]
        else:
            from cge_tpu_torch.scene import image_io

            held = image_io.decode_image(data)     # lossy: 18a holds it
            if name in (TEX_TIFF_JPEG, TEX_JPEG_CROP):
                h, w = held.shape[:2]
                err = np.abs(held.astype(int) - texels[:h, :w])
                log(f"  18c: {name}'s texels against the JPEG's: max abs "
                    f"error {int(err.max())}, mean {float(err.mean()):.3f}")
        out[name] = (data, held)
    for name in (TEX_J2K, TEX_JP2, TEX_ICNS):
        with open(os.path.join(TEX_J2K_DIR, name), "rb") as f:
            data = f.read()
        if name == TEX_J2K:
            held = texels[:J2K_CROP, :J2K_CROP]       # lossless
        else:
            from cge_tpu_torch.scene import image_io

            held = image_io.decode_image(data)     # lossy: 18a holds it
            err = np.abs(held.astype(int) - texels)
            log(f"  18c: {name}'s texels against the JPEG's: max abs error "
                f"{int(err.max())}, mean {float(err.mean()):.3f}")
        out[name] = (data, held)
    from cge_tpu_torch.scene import image_io

    for name in (TEX_LAB, TEX_MCT, TEX_OJPEG):
        with open(os.path.join(TEX_TAIL_CHIP_DIR, name), "rb") as f:
            data = f.read()
        held = image_io.decode_image(data)     # lossy: 18a holds it
        h, w = held.shape[:2]
        err = np.abs(held.astype(int) - texels[:h, :w])
        log(f"  18c: {name}'s texels against the JPEG's: max abs error "
            f"{int(err.max())}, mean {float(err.mean()):.3f}")
        out[name] = (data, held)
    for folder, name in ((TEX_LEGACY_DIR, TEX_PCD),
                         (TEX_SCIENCE_DIR, TEX_IPTC_JPEG)):
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        out[name] = (data, image_io.decode_image(data))  # 18a holds it
    return out


def tiff_writers(texels) -> dict:
    """The texels [H, W, 3] u8 as little-endian RGB TIFFs in strips of 16
    rows: raw, PackBits (literal packets of 128 bytes), Deflate with
    predictor 2, LZW (every byte a literal code, held at 9 bits by a clear
    code every 253 codes), and LZMA with predictor 2 (an .xz stream a
    strip, as libtiff writes it); {name: (file bytes, texels)}."""
    import lzma
    import struct
    import zlib

    import numpy as np

    h, w = texels.shape[:2]
    rps = 16
    strips = [texels[y:y + rps].reshape(-1, w * 3)
              for y in range(0, h, rps)]

    def packbits(rows):
        flat = rows.reshape(-1)
        n = len(flat) // 128 * 128
        body = np.concatenate([np.full((n // 128, 1), 127, np.uint8),
                               flat[:n].reshape(-1, 128)], axis=1).tobytes()
        tail = flat[n:]
        return body + (bytes((len(tail) - 1,)) + tail.tobytes()
                       if len(tail) else b"")

    def predictor2(rows):
        d = rows.astype(np.int16)
        d[:, 3:] -= rows[:, :-3]
        return (d & 0xFF).astype(np.uint8).tobytes()

    def deflate_predictor2(rows):
        return zlib.compress(predictor2(rows))

    def lzma_predictor2(rows):
        return lzma.compress(predictor2(rows), lzma.FORMAT_XZ,
                             lzma.CHECK_NONE)

    def lzw(rows):
        flat = rows.reshape(-1).astype(np.uint32)
        codes = np.concatenate(
            [np.concatenate(([256], flat[j:j + 253])) for j in range(
                0, len(flat), 253)] + [np.array([257], np.uint32)])
        bits = ((codes[:, None] >> np.arange(8, -1, -1, dtype=np.uint32))
                & 1).astype(np.uint8)
        return np.packbits(bits.reshape(-1)).tobytes()

    def tiff(chunks, compression, predictor=1):
        data = bytearray(8)
        offsets = []
        for c in chunks:
            offsets.append(len(data))
            data += c
        tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
                (259, 3, [compression]), (262, 3, [2]), (273, 4, offsets),
                (277, 3, [3]), (278, 4, [rps]),
                (279, 4, [len(c) for c in chunks]), (284, 3, [1])]
        if predictor != 1:
            tags.append((317, 3, [predictor]))
        ifd = len(data) + (len(data) & 1)
        data += bytes(ifd - len(data))
        blob_at = ifd + 2 + 12 * len(tags) + 4
        entries, blob = b"", b""
        for tag, typ, vals in tags:
            payload = struct.pack("<" + "HI"[typ == 4] * len(vals), *vals)
            if len(payload) <= 4:
                field = payload.ljust(4, b"\0")
            else:
                field = struct.pack("<I", blob_at + len(blob))
                blob += payload
            entries += struct.pack("<HHI", tag, typ, len(vals)) + field
        data[:8] = b"II*\x00" + struct.pack("<I", ifd)
        return bytes(data) + struct.pack("<H", len(tags)) + entries + \
            bytes(4) + blob

    return {"texels_raw.tif": (tiff([s.tobytes() for s in strips], 1),
                               texels),
            "texels_packbits.tif": (tiff([packbits(s) for s in strips],
                                         32773), texels),
            "texels_deflate_predictor2.tif": (tiff(
                [deflate_predictor2(s) for s in strips], 8, 2), texels),
            "texels_lzw.tif": (tiff([lzw(s) for s in strips], 5), texels),
            "texels_lzma_predictor2.tif": (tiff(
                [lzma_predictor2(s) for s in strips], 34925, 2), texels)}


def dds_writers(texels) -> dict:
    """The texels [H, W, 3] u8 (H and W multiples of 4) as DDS files:
    uncompressed A8R8G8B8 (BGRA bytes), DXT1 and BC7 mode 6, each 4x4
    block's endpoints its 5-6-5 (DXT1) or 7-bit + p-bit (BC7) minimum and
    maximum per channel and each pixel the index of the nearest colour
    between them; {name: (file bytes, the texels the file holds)}: the
    block-compressed ones hold what the port decodes them to."""
    import struct

    import numpy as np

    from cge_tpu_torch.scene import image_io

    h, w = texels.shape[:2]

    def dds(body, pfflags, fourcc=b"\0\0\0\0", bitcount=0,
            masks=(0, 0, 0, 0), dxgi=None):
        head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0)
                + bytes(44) + struct.pack("<2I4sI4I", 32, pfflags, fourcc,
                                          bitcount, *masks)
                + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
        if dxgi is not None:
            head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
        return head + body

    bgra = np.concatenate([texels[..., ::-1], np.full((h, w, 1), 255,
                                                      np.uint8)], axis=2)
    out = {"texels_a8r8g8b8.dds": (dds(bgra.tobytes(), 0x41, bitcount=32,
                                       masks=(0xFF0000, 0xFF00, 0xFF,
                                              0xFF000000)), texels)}
    blocks = texels.reshape(h // 4, 4, w // 4, 4, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, 16, 3).astype(np.int32)
    lo, hi = blocks.min(1), blocks.max(1)

    def nearest(pal, allowed=None):        # [n, k, 3] -> [n, 16] indices
        d = ((blocks[:, :, None] - pal[:, None]) ** 2).sum(-1)
        if allowed is not None:
            d = np.where(allowed[:, None], d, 1 << 30)
        return d.argmin(-1)

    # DXT1: c0 = max >= c1 = min; equal -> three-colour mode, index 0
    q = ((11, 3), (5, 2), (0, 3))          # (place, bits dropped)
    c0 = sum((hi[:, k] >> s) << sh for k, (sh, s) in enumerate(q))
    c1 = sum((lo[:, k] >> s) << sh for k, (sh, s) in enumerate(q))

    def widen(c):
        r, g, b = c >> 11 & 31, c >> 5 & 63, c & 31
        return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2],
                        axis=1)

    p0, p1 = widen(c0), widen(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], axis=1)
    idx = nearest(pal, np.stack([c0 > c1] * 4, axis=1) | (
        np.arange(4) == 0)[None])
    lut = (idx.astype(np.uint32) << (2 * np.arange(16, dtype=np.uint32))
           ).sum(-1, dtype=np.uint32)
    body = np.zeros(len(blocks), [("c0", "<u2"), ("c1", "<u2"),
                                  ("lut", "<u4")])
    body["c0"], body["c1"], body["lut"] = c0, c1, lut
    out["texels_dxt1.dds"] = dds(body.tobytes(), 0x4, b"DXT1")
    # BC7 mode 6: 7-bit endpoints, p-bit 0 on the minimum, 1 on the
    # maximum; swapped (indices reversed) where the anchor needs 4 bits
    e0, e1 = lo >> 1, hi >> 1
    wt = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                   64])
    pal = ((64 - wt)[None, :, None] * (e0 << 1)[:, None]
           + wt[None, :, None] * (e1 << 1 | 1)[:, None] + 32) >> 6
    idx = nearest(pal)
    swap = idx[:, 0] >= 8
    e0, e1 = np.where(swap[:, None], e1, e0), np.where(swap[:, None], e0, e1)
    idx = np.where(swap[:, None], 15 - idx, idx)
    n = len(blocks)
    fields = [(np.full(n, 64), 7)]
    for k in range(3):
        fields += [(e0[:, k], 7), (e1[:, k], 7)]
    fields += [(np.full(n, 127), 7), (np.full(n, 127), 7),
               (swap.astype(int), 1), (1 - swap, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    bits = np.concatenate([(np.asarray(v, np.uint32)[:, None] >> np.arange(
        nb, dtype=np.uint32)) & 1 for v, nb in fields], axis=1)
    body = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    out["texels_bc7.dds"] = dds(body.tobytes(), 0x4, b"DX10", dxgi=98)
    for name in ("texels_dxt1.dds", "texels_bc7.dds"):
        held = image_io.decode_image(out[name])       # lossy: 18a holds it
        err = np.abs(held.astype(int) - texels)
        log(f"  18c: {name}'s texels against the JPEG's: max abs error "
            f"{int(err.max())}, mean {float(err.mean()):.3f}")
        out[name] = (out[name], held)
    return out


def x11_writers(texels) -> dict:
    """The texels [H, W, 3] u8 as Pillow's other PNM modes, XBM and XPM:
    P0CMYK of their complements (k 0, which Pillow's CMYK -> RGB turns
    back into them), PyRGBA of a ramp of alpha, Pf of their red channel
    plus 0.25 (little-endian, bottom-up; f2l truncates it back), and
    their top-left X11_CROP crop as an XBM of its thresholded grey and an
    XPM of its 3-3-2 colours (2 characters a pixel), and an XPM_RGB_CROP
    crop as an XPM of all its colours (an RGB image, 3 characters a
    pixel); {name: (file bytes, the texels the file holds)}."""
    import numpy as np

    h, w = texels.shape[:2]
    out = {}
    cmyk = np.concatenate([255 - texels, np.zeros((h, w, 1), np.uint8)], 2)
    out["texels_p0cmyk.pnm"] = (b"P0CMYK\n%d %d\n255\n" % (w, h)
                                + cmyk.tobytes(), texels)
    alpha = (np.arange(w * h, dtype=np.uint32) % 251).astype(np.uint8)
    rgba = np.concatenate([texels, alpha.reshape(h, w, 1)], 2)
    out["texels_pyrgba.pnm"] = (b"PyRGBA %d %d 255\n" % (w, h)
                                + rgba.tobytes(), texels)
    red = texels[..., 0]
    pf = (red.astype(np.float32) + np.float32(0.25))[::-1]
    out["texels_red.pfm"] = (b"Pf\n%d %d\n-1.0\n" % (w, h)
                             + pf.astype("<f4").tobytes(),
                             np.repeat(red[..., None], 3, axis=2))
    crop = texels[:X11_CROP, :X11_CROP]
    ch, cw = crop.shape[:2]
    grey = crop.astype(np.uint32).sum(2) > 3 * 127
    rows = np.packbits(grey.astype(np.uint8), axis=1, bitorder="little")
    hexes = ",".join("0x%02x" % v for v in rows.reshape(-1).tolist())
    xbm = (b"#define texels_width %d\n#define texels_height %d\n"
           b"static char texels_bits[] = {\n" % (cw, ch)
           + hexes.encode() + b"\n};\n")
    out["texels_crop.xbm"] = (xbm, np.repeat(
        (grey * np.uint8(255)).astype(np.uint8)[..., None], 3, axis=2))
    chars = [bytes((c,)) for c in range(35, 127) if c != 92]

    def keys(n, k):
        return [b"".join(chars[i // len(chars) ** j % len(chars)]
                         for j in range(k)) for i in range(n)]

    def xpm(idx, colours, k):
        names = keys(len(colours), k)
        lines = [b"/* XPM */", b"static char *texels[] = {",
                 b'"%d %d %d %d",' % (idx.shape[1], idx.shape[0],
                                      len(colours), k)]
        lines += [b'"%s c #%02x%02x%02x",' % ((names[i],) + tuple(
            int(v) for v in c)) for i, c in enumerate(colours)]
        table = np.array(names, dtype=f"S{k}")
        lines += [b'"' + table[row].tobytes() + b'",' for row in idx]
        return b"\n".join(lines) + b"\n};\n"

    idx, palette = rgb332(crop)
    out["texels_crop_332.xpm"] = (xpm(idx, palette, 2), palette[idx])
    small = texels[:XPM_RGB_CROP, :XPM_RGB_CROP]
    colours, inv = np.unique(small.reshape(-1, 3), axis=0,
                             return_inverse=True)
    if len(colours) <= 256:
        raise AssertionError(f"the {XPM_RGB_CROP}x{XPM_RGB_CROP} crop has "
                             f"{len(colours)} colours, too few for an RGB "
                             f"XPM")
    out["texels_crop_rgb.xpm"] = (xpm(inv.reshape(small.shape[:2]), colours,
                                      3), small)
    return out


def legacy_writers(texels) -> dict:
    """The texels [H, W, 3] u8 as the legacy formats:
    PIXAR RGB and a version 2 GIMP brush of RGBA (the alpha a ramp) of the
    texels; an FLC (a COLOR_256 palette, BRUN lines of literal packets of
    up to 128) and an XV thumbnail of their 3-3-2 colours (the GIF's
    texels); their top-left X11_CROP crop's thresholded grey (the XBM's
    texels) as a Windows Paint 2.x file, each row one literal packet, or
    of length 0 where it is white; {name: (file bytes, the texels the file
    holds)}."""
    import struct

    import numpy as np

    h, w = texels.shape[:2]
    pxr = bytearray(1024)
    pxr[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", pxr, 416, h, w)
    struct.pack_into("<HH", pxr, 424, 14, 2)
    out = {"texels.pxr": (bytes(pxr) + texels.tobytes(), texels)}
    alpha = (np.arange(h * w, dtype=np.uint32) % 253).astype(np.uint8)
    rgba = np.concatenate([texels, alpha.reshape(h, w, 1)], axis=2)
    out["texels.gbr"] = (struct.pack(">5I", 35, 2, w, h, 4) + b"GIMP"
                         + struct.pack(">I", 25) + b"texels\0"
                         + rgba.tobytes(), texels)
    idx, palette = rgb332(texels)
    cols = [(x, min(128, w - x)) for x in range(0, w, 128)]
    lines = np.concatenate([np.full((h, 1), len(cols), np.uint8)] + [
        part for x, k in cols for part in (
            np.full((h, 1), 256 - k, np.uint8), idx[:, x:x + k])], axis=1)
    colour = struct.pack("<HBB", 1, 0, 0) + palette.tobytes()
    chunks = (struct.pack("<IH", 6 + len(colour), 4) + colour
              + struct.pack("<IH", 6 + lines.size, 15) + lines.tobytes())
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + 16 + len(chunks), 0xAF12,
                     1, w, h, 8, 3, 5)
    out["texels_332.flc"] = (bytes(head) + struct.pack(
        "<IHH8x", 16 + len(chunks), 0xF1FA, 2) + chunks, palette[idx])
    out["texels_332.xv"] = (b"P7 332\n#XVVERSION:Version 2.28\n"
                            b"#END_OF_COMMENTS\n%d %d 255\n" % (w, h)
                            + idx.tobytes(), palette[idx])
    crop = texels[:X11_CROP, :X11_CROP]
    ch, cw = crop.shape[:2]
    grey = crop.astype(np.uint32).sum(2) > 3 * 127
    rows = np.packbits(grey.astype(np.uint8), axis=1)
    stride = rows.shape[1]
    white = (rows == 0xFF).all(axis=1)
    head = bytearray(32)
    head[:4] = b"LinS"
    struct.pack_into("<HH", head, 4, cw, ch)
    struct.pack_into("<H", head, 30, int(np.bitwise_xor.reduce(
        np.frombuffer(bytes(head), "<u2"))))
    body = np.concatenate([np.full((ch, 1), stride, np.uint8), rows],
                          axis=1)[~white]
    msp = (bytes(head) + np.where(white, 0, stride + 1).astype("<u2")
           .tobytes() + body.tobytes())
    out["texels_crop.msp"] = (msp, np.repeat(
        (grey * np.uint8(255)).astype(np.uint8)[..., None], 3, axis=2))
    return out


def science_writers(texels) -> dict:
    """The texels [H, W, 3] u8 as the science formats: an IM "RGB image"
    (RGB;L: each row's red, green and blue planes, rows from the bottom),
    and their green channel (one set of grey texels) as a FITS of BITPIX 8
    (rows from the bottom), a big-endian SPIDER image (each sample plus
    0.25, which the cast to 8 bits truncates), an McIdas area of 1 byte an
    element with a 4-byte prefix a line, an IM Tools file and a raw L IPTC
    stream (8,000 bytes an (8,10) field); {name: (file bytes, the texels
    the file holds)}."""
    import struct

    import numpy as np

    h, w = texels.shape[:2]
    head = (b"Image type: RGB image\r\nImage size (x*y): %d*%d\r\n"
            b"Name: texels.im\r\n" % (w, h))
    planes = np.moveaxis(texels[::-1], 2, 1)             # [H, 3, W]
    out = {"texels_rgb_l.im": (head + bytes(511 - len(head)) + b"\x1a"
                               + planes.tobytes(), texels)}
    grey = np.ascontiguousarray(texels[..., 1])
    held = np.repeat(grey[..., None], 3, axis=2)
    cards = [b"SIMPLE  = %20s" % b"T", b"BITPIX  = %20d" % 8,
             b"NAXIS   = %20d" % 2, b"NAXIS1  = %20d" % w,
             b"NAXIS2  = %20d" % h, b"END"]
    fits = b"".join(c.ljust(80) for c in cards)
    fits += b" " * (-len(fits) % 2880) + grey[::-1].tobytes()
    out["texels_green.fits"] = (fits + bytes(-len(fits) % 2880), held)
    hdr = [0.0] * 28
    hdr[1], hdr[2], hdr[5], hdr[12] = 1.0, h, 1.0, w
    labrec = -(-1024 // (4 * w))
    hdr[13], hdr[22], hdr[23] = labrec, labrec * 4 * w, 4 * w
    spi = struct.pack(">27f", *hdr[1:]).ljust(labrec * 4 * w, b"\0")
    out["texels_green.spi"] = (spi + (grey.astype(">f4") + np.float32(
        0.25)).astype(">f4").tobytes(), held)
    words = [0] * 65
    words[2], words[9], words[10], words[11], words[14], words[15] = (
        4, h, w, 1, 1, 4)
    words[34] = 256
    lines = np.concatenate([np.full((h, 4), 0xA5, np.uint8), grey], axis=1)
    out["texels_green.mcidas"] = (struct.pack("!64i", *words[1:])
                                  + lines.tobytes(), held)
    out["texels_green.imt"] = (b"width %d\nheight %d\npixel n8\n\x0c" % (
        w, h) + grey.tobytes(), held)
    raw = grey.tobytes()
    iptc = b"".join(b"\x1c" + bytes(rt) + struct.pack(">H", len(v)) + v for
                    rt, v in (((3, 60), b"\x01\x00"),
                              ((3, 20), struct.pack(">I", w)),
                              ((3, 30), struct.pack(">I", h)),
                              ((3, 120), b"\x01")))
    iptc += b"".join(b"\x1c\x08\x0a" + struct.pack(">H", len(raw[i:i + 8000]))
                     + raw[i:i + 8000] for i in range(0, len(raw), 8000))
    out["texels_green_raw.iim"] = (iptc, held)
    return out


def asset_writers(texels) -> dict:
    """The texels [H, W, 3] u8 (W a multiple of 2) as the formats of model
    and game asset sets: SGI run-length (copy packets of up to 127 bytes),
    PCX of three 8-bit planes (bytes of 0xC0 and above as runs of one), QOI
    (an RGB op a pixel), Sun raster run-length (each 0x80 escaped), BLP2
    of a 3-3-2 palette, FTEX raw RGB and a 256x256 24-bit ICO entry with its
    AND mask; {name: (file bytes, the texels the file holds)}."""
    import struct

    import numpy as np

    h, w = texels.shape[:2]
    # SGI: rows bottom-up, each channel's row as copy packets, then 0
    planes = np.ascontiguousarray(texels[::-1].transpose(2, 0, 1)).reshape(
        3 * h, w)
    full, rem = divmod(w, 127)
    parts = [np.concatenate([np.full((3 * h, full, 1), 0xFF, np.uint8),
                             planes[:, :full * 127].reshape(3 * h, full,
                                                            127)],
                            axis=2).reshape(3 * h, -1)]
    if rem:
        parts += [np.full((3 * h, 1), 0x80 | rem, np.uint8),
                  planes[:, full * 127:]]
    rows = np.concatenate(parts + [np.zeros((3 * h, 1), np.uint8)], axis=1)
    n = rows.shape[1]
    starts = 512 + 24 * h + n * np.arange(3 * h, dtype=np.int64)
    sgi = (struct.pack(">HBBHHHH", 474, 1, 1, 3, w, h, 3).ljust(512, b"\0")
           + starts.astype(">u4").tobytes()
           + np.full(3 * h, n, ">u4").tobytes() + rows.tobytes())
    out = {"texels.sgi": (sgi, texels)}

    def escaped(flat, mark, lead):
        """flat with each byte that `mark` selects preceded by lead."""
        at = np.arange(len(flat)) + np.cumsum(mark)
        body = np.empty(len(flat) + int(mark.sum()), np.uint8)
        body[at] = flat
        body[at[mark] - 1] = lead
        return body.tobytes()

    pcx_rows = np.ascontiguousarray(texels.transpose(0, 2, 1)).reshape(-1)
    pcx = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 72,
                       72) + bytes(49) + bytes((3,))
           + struct.pack("<HH", w, 1) + bytes(58)
           + escaped(pcx_rows, pcx_rows >= 0xC0, 0xC1))
    out["texels.pcx"] = (pcx, texels)
    ops = np.concatenate([np.full((h * w, 1), 0xFE, np.uint8),
                          texels.reshape(-1, 3)], axis=1)
    qoi = (b"qoif" + struct.pack(">IIBB", w, h, 3, 0) + ops.tobytes()
           + bytes(7) + b"\x01")
    out["texels.qoi"] = (qoi, texels)
    bgr = np.ascontiguousarray(texels[..., ::-1]).reshape(-1)
    mark = bgr == 0x80                     # each 0x80 as 0x80 0x00
    body = escaped(np.where(mark, 0, bgr).astype(np.uint8), mark, 0x80)
    sun = struct.pack(">8I", 0x59A66A95, w, h, 24, len(body), 2, 0,
                      0) + body
    out["texels.ras"] = (sun, texels)
    idx, palette = rgb332(texels)
    bgra = np.concatenate([palette[:, ::-1], np.zeros((256, 1), np.uint8)],
                          axis=1)
    blp = (b"BLP2" + struct.pack("<ibbbbII", 1, 1, 0, 0, 0, w, h)
           + struct.pack("<16I", 20 + 128 + 1024, *[0] * 15)
           + struct.pack("<16I", h * w, *[0] * 15) + bgra.tobytes()
           + idx.tobytes())
    out["texels.blp"] = (blp, palette[idx])
    ftex = (b"FTEX" + struct.pack("<5i", 1, w, h, 1, 1)
            + struct.pack("<2ii", 1, 32, h * w * 3) + texels.tobytes())
    out["texels.ftu"] = (ftex, texels)
    side = min(256, h, w)
    crop = texels[:side, :side]
    stride = side * 3
    dib = (struct.pack("<IiiHHIIiiII", 40, side, 2 * side, 1, 24, 0,
                       stride * side, 0, 0, 0, 0)
           + np.ascontiguousarray(crop[::-1, :, ::-1]).tobytes()
           + bytes(side // 8 * side))
    ico = struct.pack("<HHH", 0, 1, 1) + struct.pack(
        "<BBBBHHII", side % 256, side % 256, 0, 0, 1, 24, len(dib),
        22) + dib
    out[f"texels_{side}.ico"] = (ico, crop)
    return out


def textured_dragon(tmp, texture, grid, device):
    """The dragon stand-in at `grid` with its body's map_Kd the file
    `texture` (copied beside the OBJ), loaded on `device`; the load's
    seconds. The OBJ and MTL are written once a grid into tmp; each
    texture's folder holds a hard link to the OBJ and a copy of the MTL."""
    import shutil

    import cge_tpu_torch as ct
    from cge_tpu_torch.scene.standin import write_obj

    base = os.path.join(tmp, f"dragon_{grid[0]}x{grid[1]}")
    if not os.path.isdir(base):
        os.makedirs(base)
        write_obj(os.path.join(base, "dragon.obj"), *grid)
    stem = os.path.splitext(os.path.basename(texture))[0]
    os.makedirs(os.path.join(tmp, stem))
    obj = os.path.join(tmp, stem, "dragon.obj")
    os.link(os.path.join(base, "dragon.obj"), obj)    # 45 MB, read only
    shutil.copy(os.path.join(base, "dragon.mtl"), os.path.dirname(obj))
    shutil.copy(texture, os.path.dirname(obj))
    mtl = os.path.splitext(obj)[0] + ".mtl"
    with open(mtl) as f:
        text = f.read()
    body = "newmtl dragonBody\n"
    with open(mtl, "w") as f:
        f.write(text.replace(
            body, body + f"map_Kd {os.path.basename(texture)}\n"))
    t0 = time.perf_counter()
    scene = ct.load_scene_from_file(obj, [ct.PointLight(*LIGHT)],
                                    device=device)
    torch_sync(device)
    return scene, time.perf_counter() - t0


def torch_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eleventh_path(device) -> dict:
    """Phase 18: the texture fixtures (texture_fixtures), then the dragon
    textured by the 1024x1024 JPEG at 512x512 with the accel against the
    same dragon textured by the PNG the port writes from the decoded
    texels, then by those texels as TGA, PNM, PSD, GIF, TIFF, WebP, DDS,
    SGI, PCX, QOI, Sun raster, BLP, FTEX, ICO, JPEG 2000, ICNS, XBM, XPM,
    PIXAR, GIMP brush, FLC, XV thumbnail and Windows Paint files, Pillow's
    other PNM modes, a PhotoCD, IM, FITS, SPIDER, McIdas, IM Tools and
    IPTC files of them, and an IPTC stream of a grey JPEG crop in its
    green band (new_format_frames)."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from bench_torch import cells as bc
    from cge_tpu_torch.ops import cluster_sweep
    from cge_tpu_torch.render import graphs
    from cge_tpu_torch.scene import image_io

    log(f"[18] textures without Pillow: the fixtures, then the dragon "
        f"textured by a 1024x1024 progressive JPEG and by its texels as TGA, "
        f"PNM, PSD, GIF, TIFF (raw, PackBits, Deflate + predictor 2, LZW, "
        f"LZMA + predictor 2, tiled YCbCr JPEG), WebP (lossy, and a lossless "
        f"crop), DDS (A8R8G8B8, DXT1, BC7), a crop as an arithmetic, "
        f"progressive, smoothed YCCK 4:4:0 JPEG, SGI run-length, PCX, QOI, "
        f"Sun raster run-length, BLP2 palette, FTEX, a 256x256 ICO, a "
        f"lossless 512x512 J2K crop, a lossy JP2 and an ICNS of it, a "
        f"512x512 L*a*b* TIFF crop, a JP2 with Part 2 MCT markers, an "
        f"old-style JPEG TIFF, P0CMYK, PyRGBA and Pf PNM, XBM and XPM "
        f"(palette and RGB) crops, PIXAR, a GIMP brush, a 3-3-2 FLC and XV "
        f"thumbnail, a Windows Paint crop, a 768x512 PhotoCD, an RGB IM, "
        f"FITS, SPIDER, McIdas, IM Tools and raw IPTC of their green, and an "
        f"IPTC of a grey JPEG crop in band 2 | {SMI['line']} (decode and "
        f"load times are the host's)")
    times = texture_fixtures()
    for kind in sorted({k for _, k, _ in times}):
        ms = sorted((t, n) for n, k, t in times if k == kind)
        log(f"  {kind}: {len(ms)} files, {ms[0][0]:.2f}-{ms[-1][0]:.2f} ms "
            f"a file (the slowest {ms[-1][1]})")
    for kind, prefixes in JPEG_VARIANT_KINDS:
        ms = sorted(t for n, _, t in times if n.startswith(prefixes)
                    and not (kind == "arithmetic" and "_smooth_" in n))
        log(f"  JPEG {kind}: {len(ms)} files, {ms[0]:.2f}-{ms[-1]:.2f} ms "
            f"a file, median {ms[len(ms) // 2]:.2f} ms")
    for kind, prefixes in TAIL_KINDS:
        ms = sorted(t for n, _, t in times if n.startswith(prefixes))
        log(f"  {kind}: {len(ms)} files, {ms[0]:.2f}-{ms[-1]:.2f} ms a "
            f"file, median {ms[len(ms) // 2]:.2f} ms")
    for name in (TEX_LAB, TEX_MCT, TEX_OJPEG):
        log(f"  18a: {name}: decode "
            f"{next(t for n, _, t in times if n == name):.2f} ms (host)")
    log(f"  18a: {len(times)} fixtures decoded, every SHA-256 equal to the "
        f"manifest's, {sum(t for _, _, t in times):.1f} ms in all (host) | "
        f"{SMI['line']}")
    cell = bc.BY_NAME["scale512"]
    feats = ct.Features(**dict(cell.features, enable_texture_mapping=True,
                               enable_bilinear_texture_filtering=True))
    params = ct.RenderParams(**cell.params)
    jpeg = os.path.join(TEXTURES, TEX_JPEG)
    with tempfile.TemporaryDirectory() as tmp:
        scene, load_s = textured_dragon(tmp, jpeg, cell.grid, device)
        sorts = []
        real_sort = cluster_sweep.sort_keys

        def counted_sort(keys):
            sorts.append(keys.shape)
            return real_sort(keys)

        reset_launches()
        cluster_sweep.sort_keys = counted_sort
        try:
            with graphs._eager_bounces():
                first = ct.render_image_u8(scene, ct.Camera(), feats, params,
                                           W, H)
            torch_sync(device)
        finally:
            cluster_sweep.sort_keys = real_sort
        launches = read_launches()
        launches["sort"] = len(sorts)
        if not (launches["keys"] and launches["walk"] and launches["sort"]):
            raise AssertionError(f"the textured frame launched {launches}")
        if launches["sweep"]:
            raise AssertionError(f"the accel frame launched K3: {launches}")
        frames, times_ms = [], []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            frames.append(ct.render_image_u8(scene, ct.Camera(), feats,
                                             params, W, H))
            end.record()
            torch.cuda.synchronize()
            times_ms.append(start.elapsed_time(end))
        texels = image_io.load_image(jpeg).pixels
        png = os.path.join(tmp, "texels.png")
        image_io.write_png(png, np.rint(texels * 255).astype(np.uint8))
        del scene
        png_scene, png_load_s = textured_dragon(tmp, png, cell.grid,
                                               device)
        ref = ct.render_image_u8(png_scene, ct.Camera(), feats, params, W, H)
        torch_sync(device)
        del png_scene
        same = [bool(torch.equal(f, ref)) for f in [first] + frames]
        lit = float((ref.float().sum(-1) > 0).float().mean())
        log(f"  18b: dragon ({cell.grid[0]}x{cell.grid[1]} grid) textured "
            f"by {TEX_JPEG}: load {load_s:.2f} s (PNG texels: "
            f"{png_load_s:.2f} s), launches of the first frame {launches}, "
            f"frames ms {[round(x, 2) for x in times_ms]} median "
            f"{float(np.median(times_ms)):.2f} ms, lit {lit:.3f}, equal to "
            f"the PNG-textured frame: {same} | {SMI['line']}")
        if not all(same):
            raise AssertionError("the JPEG-textured frame differs from the "
                                 "frame textured by its PNG-written texels")
        if lit < 0.05:
            raise AssertionError(f"the textured frame is blank: {lit:.4f}")
        formats = new_format_frames(tmp, texels, ref, cell.grid, feats,
                                    params, device, launches)
    return dict(fixtures=times, load_s=load_s, frame_ms=times_ms,
                launches=launches, formats=formats)


def new_format_frames(tmp, texels, png_frame, grid, feats, params,
                      device, first_launches) -> dict:
    """Phase 18c: the dragon textured by the texels as TGA, PNM, PSD, GIF,
    TIFF, WebP, DDS, SGI, PCX, QOI, Sun raster, BLP, FTEX, ICO, JPEG 2000
    (J2K and JP2) and ICNS files, a L*a*b* TIFF, a JP2 with Part 2
    markers, an old-style JPEG TIFF, P0CMYK, PyRGBA and Pf PNM files, XBM
    and XPM crops, PIXAR, GIMP brush, FLC, XV thumbnail and Windows Paint
    files, a PhotoCD, IM, FITS, SPIDER, McIdas, IM Tools and IPTC files
    (texture_writers), each one first frame, timed,
    against the PNG-textured frame of the same texels (rendered once for
    each set of texels), its K1 and K2 launches against (b)'s
    (first_launches); {file: (decode ms, load s, first frame ms)}."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct
    from cge_tpu_torch.scene import image_io

    u8 = np.rint(texels * 255).astype(np.uint8)
    t0 = time.perf_counter()
    paeth = image_io.png_bytes(u8, filters=(4,))
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = image_io.decode_image(paeth)
    paeth_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(back, u8):
        raise AssertionError("the Paeth-filtered PNG decodes to other texels")
    log(f"  18c: {u8.shape[1]}x{u8.shape[0]} texels as an RGB PNG, every "
        f"row Paeth-filtered: decode {paeth_ms:.2f} ms (written in "
        f"{write_ms:.0f} ms) | {SMI['line']} (host)")
    out = {}
    refs = {}               # the frames of the PNGs of texels held so far
    for name, (data, held) in texture_writers(u8).items():
        t0 = time.perf_counter()
        got = image_io.decode_image(data)
        decode_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, held):
            raise AssertionError(f"{name} decodes to other texels than the "
                                 f"ones written")
        stem, ext = os.path.splitext(name)
        path = os.path.join(tmp, f"{stem}_{ext[1:]}{ext}")
        with open(path, "wb") as f:
            f.write(data)
        ref = png_frame
        if not np.array_equal(held, u8):    # palettes, crops, lossy: own PNG
            key = (held.shape, held.tobytes())
            if key not in refs:             # (one a set of texels)
                png = os.path.join(tmp, f"{stem}_{ext[1:]}_png.png")
                image_io.write_png(png, held)
                png_scene, _ = textured_dragon(tmp, png, grid, device)
                refs[key] = ct.render_image_u8(png_scene, ct.Camera(), feats,
                                               params, W, H)
                del png_scene
            ref = refs[key]
        scene, load_s = textured_dragon(tmp, path, grid, device)
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame = ct.render_image_u8(scene, ct.Camera(), feats, params, W, H)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        frame_ms = start.elapsed_time(end)
        del scene
        same = bool(torch.equal(frame, ref))
        log(f"  18c: dragon textured by {name} ({len(data)} bytes): decode "
            f"{decode_ms:.2f} ms (host), load {load_s:.2f} s, launches of "
            f"the first frame {launches}, first frame {frame_ms:.2f} ms, "
            f"equal to the frame of the PNG of its texels: {same} | "
            f"{SMI['line']}")
        if not (launches["keys"] and launches["walk"]) or any(
                launches[k] != first_launches[k] for k in ("keys", "walk")):
            raise AssertionError(f"{name}: the textured frame launched "
                                 f"{launches}, the JPEG's first frame "
                                 f"{first_launches}")
        if not same:
            raise AssertionError(f"the {name}-textured frame differs from "
                                 f"the frame textured by the PNG of its "
                                 f"texels")
        out[name] = (decode_ms, load_s, frame_ms)
    out["texels.png (Paeth)"] = (paeth_ms, None, None)
    return out


def multi_card(cards: int) -> int:
    """`python3 chip_smoke.py --cards N`: the sharded entry points on NCCL,
    one rank a card, over N cards (N even): the headline dragon frame at
    rays = N (each rank's frame bit for bit render_image's on its card,
    and the gathered frame the one here), at rays x prims = N/2 x 2 (the
    image rule) with its primary rays' prims sweep (hits and t equal to
    the single sweep), and the train step at N x 1 and N/2 x 2 against
    loss_and_grads; every rank's launches, frame ms and collectives."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        log(f"FAIL: --cards {cards} needs {cards} CUDA devices, "
            f"{torch.cuda.device_count()} found")
        return 1
    sys.path.insert(0, REPO)
    try:
        import cge_tpu_torch as ct
        from cge_tpu_torch import _kernels
        from cge_tpu_torch.scene.standin import write_obj
    except ImportError as e:
        log(f"FAIL: the port is not importable next to this script: {e}")
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for ln in smi.stdout.strip().splitlines():
        log(ln)
    SMI["line"] = smi.stdout.strip().splitlines()[0]
    lib = _kernels.library()
    log(f"[1] kernels built in {lib.build_seconds:.1f} s")
    half = cards // 2
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "dragon.obj")
        write_obj(obj)
        tobj = os.path.join(tmp, "dragon_teapot.obj")
        write_obj(tobj, *TEAPOT_GRID)
        dragon = ct.load_scene_from_file(obj, [ct.PointLight(*LIGHT)],
                                         device=device)
        tscene = ct.load_scene_from_file(tobj, [ct.PointLight(*LIGHT)],
                                         device=device)
        feats, params = ct.Features(**HEADLINE), ct.RenderParams(**MAIN_PARAMS)
        ctx = ct.prepare_render(dragon, feats, params)
        frame = dict(features=HEADLINE, params=MAIN_PARAMS, side=EIGHTH_SIDE)
        rays, grid = f"rays_{cards}x1", f"grid_{half}x2"
        jobs = [dict(kind="frame", name=rays, scene="dragon",
                     mesh=(cards, 1), single=True, **frame),
                dict(kind="frame", name=grid, scene="dragon",
                     mesh=(half, 2), **frame),
                dict(kind="sweep", name="prims_sweep", scene="dragon",
                     mesh=(half, 2), accel=True, side=EIGHTH_SIDE),
                dict(kind="train", name=f"train_{cards}x1",
                     scene="standin", mesh=(cards, 1)),
                dict(kind="train", name=f"train_{half}x2", scene="standin",
                     mesh=(half, 2))]
        log(f"[14] the sharded entry points on {cards} cards, NCCL, one "
            f"rank a card | {SMI['line']}")
        shared = _shared_inputs(tmp, obj, tobj)
        results, arrays, _ = run_world(tmp, f"nccl, {cards} ranks", "nccl",
                                       cards, 600, jobs, shared)
        for name in (rays, grid, "prims_sweep"):
            _need_launches(results[name], name, ("keys", "walk"), ("sweep",))
        for name in (f"train_{cards}x1", f"train_{half}x2"):
            _need_launches(results[name], name, ("sweep",), ("keys", "walk"))
        if not all(s["equal_single"] and s["equal_eager"] and s["graphs"]
                   for s in results[rays]):
            raise AssertionError("a rank's frame differs from its "
                                 "render_image or its eager bounces, or "
                                 "replayed no graph")
        ref = ct.render_image(dragon, ct.Camera(), feats, params,
                              EIGHTH_SIDE, EIGHTH_SIDE,
                              ctx=ctx).cpu().numpy()
        checks = [check_exact(arrays[rays], ref, f"rays = {cards} frame"),
                  check_image(arrays[grid], ref, f"{half} x 2 frame"),
                  check_prims_sweep(arrays, "prims_sweep", dragon, ctx,
                                    device)]
        checks += check_train(arrays, (f"train_{cards}x1",
                                       f"train_{half}x2"), tscene, shared,
                              device)
        for line in checks:
            log("    " + line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    sys.path.insert(0, REPO)
    try:
        import cge_tpu_torch as ct
        from cge_tpu_torch import _kernels
        from cge_tpu_torch.ops import cluster_sweep as cs
        from cge_tpu_torch.render import graphs
        from cge_tpu_torch.scene.standin import write_obj
    except ImportError as e:
        log(f"FAIL: the port is not importable next to this script: {e}")
        return 1
    import numpy as np

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    SMI["line"] = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                   else f"nvidia-smi: {smi.stderr.strip()}")
    log(SMI["line"])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # phase 1: build
    lib = _kernels.library()
    log(f"[1] kernels built in {lib.build_seconds:.1f} s -> "
        f"{os.path.relpath(lib.path, REPO)}")
    for ln in lib.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            log("    " + ln.strip())
    from cge_tpu_torch.tools import sass_count
    try:
        sass = sass_count.library_sass(lib.path)
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        log(f"    K1's SASS not read: {e}")
    else:
        log("    K1's loops by instruction kind (tools/sass_count.py):")
        for ln in sass_count.report(sass):
            log("      " + ln)

    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "dragon.obj")
        t0 = time.perf_counter()
        write_obj(obj)
        t1 = time.perf_counter()
        scene = ct.load_scene_from_file(obj, [ct.PointLight(*LIGHT)],
                                        device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        feats = ct.Features(**HEADLINE)
        params = ct.RenderParams(**MAIN_PARAMS)
        ctx = ct.prepare_render(scene, feats, params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        log(f"    dragon: {int(scene.tri_mask.sum())} triangles, "
            f"{scene.cluster_perm.shape[0]} clusters, tiles "
            f"{tuple(ctx.accel.tiles.shape)} ({ctx.accel.layout}), "
            f"write {t1 - t0:.1f} s load {t2 - t1:.1f} s "
            f"prepare {t3 - t2:.2f} s")

        # phase 2: kernels vs twins
        log("[2] kernels vs twins (same inputs on the card)")
        report = check_kernels(scene, ctx, device)

        # phase 3: the main path
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = ct.render_image_u8(scene, ct.Camera(), feats, params, W, H,
                                 ctx=ctx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
        if img.shape != (H, W, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"image {tuple(img.shape)} {img.dtype}")
        lit = float((img.float().sum(-1) > 0).float().mean())
        if lit < 0.05:
            raise AssertionError(f"image is blank: {lit:.4f} lit pixels")
        for k in ("keys", "walk"):
            if launches[k] <= 0:
                raise AssertionError(f"main path never launched kernel {k}")
        if launches["sweep"] or launches["walk_refine"] or launches["walk_mxu"]:
            raise AssertionError(f"the accel path launched {launches}")
        frames = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ct.render_image_u8(scene, ct.Camera(), feats, params, W, H,
                               ctx=ctx)
            end.record()
            torch.cuda.synchronize()
            frames.append(start.elapsed_time(end))
        ms = float(np.median(frames))
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"[3] main path 512x512: launches {launches}, lit {lit:.3f}, "
            f"first frame {first_s:.2f} s, frames ms "
            f"{[round(x, 2) for x in frames]}, median {ms:.2f} ms, "
            f"{W * H * 2 / ms / 1e3:.3f} Mrays/s (primary + one shadow ray "
            f"per pixel), peak memory {peak:.0f} MiB")

        # phase 4: golden and GPU-vs-CPU
        gimg = ct.render_image(scene, ct.Camera(),
                               ct.Features(**GOLDEN_FEATURES),
                               ct.RenderParams(), 256, 256).cpu().numpy()
        frac, q = golden_check(gimg)
        log(f"[4] golden dragon_scale_256: {frac:.4%} pixels close, "
            f"99.99th pct err {q:.3g} (need >= 99.5%, < 0.05)")
        if frac < 0.995 or q >= 0.05:
            raise AssertionError("golden mismatch")
        nan_agree, frac = small_scene_check(device, tmp)
        log(f"    small dragon 64x64, card vs CPU twins: NaN agree "
            f"{nan_agree:.4f}, {frac:.4%} pixels close")
        if nan_agree < 0.999 or frac < 0.995:
            raise AssertionError("card and CPU renders disagree")

        # phase 5: K3 vs its twin on the teapot-size stand-in
        tobj = os.path.join(tmp, "dragon_teapot.obj")
        write_obj(tobj, *TEAPOT_GRID)
        tscene = ct.load_scene_from_file(tobj, [ct.PointLight(*LIGHT)],
                                         device=device)
        tctx = ct.prepare_render(tscene, ct.Features(**BRUTE),
                                 ct.RenderParams())
        log(f"[5] K3 vs twin ({int(tscene.tri_mask.sum())} triangles, "
            f"table {tuple(tctx.tri_table.shape)})")
        report["sweep"] = check_sweep(tctx, device)

        # phases 6 and 7: the accel-off render and the train step
        brute_launches = brute_path(tscene, tctx, device)
        train_path(tscene, device)
        small_train_check(device, tmp)

        # phase 8: K2's refine and mxu modes against their twins
        log("[8] K2 refine_members and mxu vs twins (same inputs, card)")
        modes = check_modes(scene, ctx.accel, tscene, device)

        # phases 9 and 10: the tuning path, then K4 against its twin
        tool_launches = tuning_path(tscene, device)
        report["stream"] = check_stream(device)

        # phases 11-13 spy on the trace's functions and read its
        # record_function spans, which a graph replay does not call: they
        # run with eager bounces
        with graphs._eager_bounces():
            # phase 11: the sampling and image-space features
            fifth_path(tmp, scene, ctx.accel, device)

            # phase 12: transparency shadows, the tree, glossy, batches
            sixth_path(tmp, scene, ctx, device)

            # phase 13: the CLI and config, the reference BVH, the
            # debugger, the preview and the app
            seventh_path(tmp, scene, tobj, tscene, device)

        # phase 14: multi-device on the one card, the native library
        eighth_path(tmp, obj, tobj, scene, ctx, tscene, tctx, device)

        # phase 15: the compiled library's cases, frame attribution
        ninth_path(scene, ctx, tscene, tctx, device)

    # phase 16: the benchmark's cells
    tenth_path(device)

    # phase 17: the bounces as CUDA graph replays against eager bounces
    graphs_path(device)

    # phase 18: textures decoded without Pillow
    eleventh_path(device)

    src = "cge_tpu_torch/csrc/cluster_sweep.cu"
    pallas = "cge_tpu/ops/pallas/cluster_sweep.py"
    # (name, counter, source, the TPU kernel's pallas_call, its report);
    # launches: K1, K2 per 512x512 dragon frame (phase 3), K3 per
    # accel-off frame (phase 6), the opt-in modes and K4 on the tuning
    # path (phase 9)
    rows = (
        ("block_entry_keys", "keys", src, f"{pallas}:292", report["keys"],
         launches),
        ("cluster_walk", "walk", src, f"{pallas}:652", report["walk"],
         launches),
        ("closest_tris_sweep", "sweep", "cge_tpu_torch/csrc/sweep.cu",
         "cge_tpu/ops/pallas/sweep.py:150", report["sweep"], brute_launches),
        ("cluster_walk_refine", "walk_refine", src, f"{pallas}:652",
         modes["refine"], tool_launches),
        ("cluster_walk_mxu", "walk_mxu", src, f"{pallas}:652", modes["mxu"],
         tool_launches),
        ("stream_sum", "stream_probe", "cge_tpu_torch/csrc/stream_probe.cu",
         "tools/exp_dma_layout.py:53", report["stream"], tool_launches),
    )
    log("[summary] kernel: ms (earlier ms) | bound ms (kind), share | "
        "launches (per frame for K1, K2, K3; tuning path for the rest)")
    kernels = []
    for name, counter, source, replaces, r, counts in rows:
        log(f"  {name}: {r['ms']:.4f} ({EARLIER_MS[counter]}) | "
            f"{r['bound'][0]:.4f} ({r['bound'][1]}), "
            f"{r['bound'][0] / r['ms']:.3f} | {counts[counter]}")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[counter], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cards":
        sys.exit(multi_card(int(sys.argv[2])))
    sys.exit(main())
