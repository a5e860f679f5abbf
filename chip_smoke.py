#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cge_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs a CUDA card, builds the port's kernels from csrc/ with nvcc, and
exits non-zero if any phase fails:

  1. the card's name and power limit, the kernel build, and K1's inner
     loops counted by instruction kind from the SASS
     (cge_tpu_torch/tools/sass_count.py);
  2. K1 and K2 against their plain PyTorch twins on the card, on the full
     614,400-triangle dragon stand-in (tools/make_large_asset.py), through
     cge_tpu_torch/tools/kernel_bench.py's rows: primary rays and a
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
     the same step on the card against the CPU twins for the small scene;
  8. K2's opt-in modes against their twins on the card: refine_members (in
     the split walk) on the dragon at 2 clusters per visit (field layout)
     and on the 15,360-triangle stand-in (triangle layout), closest and
     any-hit, bit for bit and against the walk without refine, with the
     dense tiles it skipped; the tensor-core mxu mode (the one-thread-per-
     ray kernel) on the stand-in against its twin
     and the default walk, within MXU_TOL; the times of every mode and
     twin;
  9. the fourth path, kernel tuning: each tool of cge_tpu_torch.tools at
     a quick size (kernel_bench with --shapes: K2 in every split shape,
     K3 under each split rule), then a 512x512
     render of the stand-in with the accel,
     frustum keys for both sweeps and the coherence ray order for bounces
     and shadows, held against the default accel render;
 10. K4, the streaming probe, against its twin on the three tile layouts
     at the dragon's scale, with GB/s per layout.

Each path is driven with the launch counters set to 0 just before it and
read just after. A summary gives each kernel's time beside its earlier
design's (PERF.md), its bound, share and launches per frame. The line
before the last is a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
SEED = 0
# the knobs of the tuning path's render: frustum keys and ray sorting
ALL_KNOBS = dict(sweep_exact_keys=False, sweep_anyhit_exact_keys=False,
                 sweep_sort_bounce=True, sweep_sort_shadow=True)
# mxu against its twin or the default walk: the two-dot form on 3xTF32
# products rounds differently, so a grazing ray may flip
MXU_TOL = dict(hit_frac=0.9999, id_frac=0.9999, t_rel=1e-5)
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


def log(msg: str) -> None:
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
    from tools.make_large_asset import write_obj

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
    from cge_tpu_torch.render.wavefront import trace

    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    o, d = camera_rays(TRAIN_SIDE, device)
    leaves = ct.scene_params(scene)
    perturbed = ct.with_params(scene, {
        **leaves, "mat_kd": leaves["mat_kd"] * 0.8,
        "point_pos": leaves["point_pos"] + 0.1})
    with torch.no_grad():
        target = torch.nan_to_num(trace(perturbed, o, d, feats, params))
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


def small_train_check(device, tmp):
    """The same step on the card and on the CPU twins for the 41x32
    stand-in at 64x64 rays: loss to 1e-3 relative, each gradient within
    1e-2 of its norm (the card sums in another order, with atomics in the
    gathers' backward, and a ray that grazes an edge may land on either
    side)."""
    import numpy as np
    import torch

    import cge_tpu_torch as ct

    path = os.path.join(tmp, "dragon_small.obj")
    if not os.path.exists(path):
        from tools.make_large_asset import write_obj
        write_obj(path, 41, 32)
    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    rng = np.random.default_rng(SEED)
    target = torch.from_numpy(
        rng.uniform(0.0, 0.5, (64 * 64, 3)).astype(np.float32))
    o, d = camera_rays(64, "cpu")      # both sides trace the same rays
    out = []
    for dev in (device, torch.device("cpu")):
        s = ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)],
                                    device=dev)
        loss, g = ct.loss_and_grads(s, o.to(dev), d.to(dev), target.to(dev),
                                    feats, params)
        out.append((float(loss), {k: v.cpu() for k, v in g.items()}))
    (gl, gg), (cl, cg) = out
    rel = {k: float((gg[k] - cg[k]).norm() / cg[k].norm())
           for k in cg if float(cg[k].norm()) > 0}
    worst = max(rel, key=rel.get)
    log(f"    small train step, card vs CPU twins: loss {gl:.8g} vs "
        f"{cl:.8g}, worst gradient {worst} at {rel[worst]:.3g} of its norm")
    if abs(gl - cl) > 1e-3 * abs(cl) or rel[worst] > 1e-2:
        raise AssertionError("card and CPU train steps disagree")


# ---------------------------------------------------------------------------
# phase 8: K2's opt-in modes against their twins
# ---------------------------------------------------------------------------

def _mode_batches(scene, accel, device, pullback: float = 0.0):
    """(o, d, tmax, any-hit) of the primary, bounce-like and shadow batches
    of kernel_bench.walk_batches for this scene and accel."""
    from cge_tpu_torch.tools import kernel_bench

    batches = kernel_bench.walk_batches(scene, accel, device,
                                        pullback=pullback)
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


def mxu_agreement(got, want, any_hit: bool):
    """(hit fraction, id fraction over rays that hit on both sides, max
    |dt| / max(1, t) over rays with equal ids, max |dt| there)."""
    import torch

    t, i = got[0].reshape(-1), got[1].reshape(-1)
    tw, iw = want[0].reshape(-1), want[1].reshape(-1)
    h = (i > 0) if any_hit else torch.isfinite(t)
    hw = (iw > 0) if any_hit else torch.isfinite(tw)
    hit_frac = float((h == hw).float().mean())
    if any_hit:
        return hit_frac, 1.0, 0.0, 0.0
    both = h & hw
    same = both & (i == iw)
    id_frac = float(same.sum()) / max(1, int(both.sum()))
    if not same.any():
        return hit_frac, id_frac, 0.0, 0.0
    err = (t - tw).abs()[same]
    rel = float((err / tw.abs()[same].clamp_min(1.0)).max())
    return hit_frac, id_frac, rel, float(err.max())


def check_mxu(scene, accel, device, stats):
    """The tensor-core mode on the card against its twin (torch.matmul,
    TF32 off) and against the default walk, within MXU_TOL. The secondary
    rays start or end 1e-3 off the surface, as the renderer's offsets and
    the CPU fixtures put them: a ray that starts on a surface meets it at
    t ~ 0, where the t >= 0 test flips under any change of rounding."""
    from cge_tpu_torch.ops import cluster_sweep as cs
    from cge_tpu_torch.tools import kernel_bench

    for name, batch in _mode_batches(scene, accel, device, 1e-3).items():
        args, kw = _walk_inputs(batch, accel, 1)
        any_hit = kw["any_hit"]
        got = cs.cluster_walk(*args, mxu=True, **kw)
        twin = cs.cluster_walk_plain(*args, mxu=True, **kw)
        base = cs.cluster_walk(*args, **kw)
        kernel_bench.check_equal(base, cs.cluster_walk_plain(*args, **kw),
                                 f"stand-in {name}: K2")
        rows = []
        for other, ref in (("twin", twin), ("default walk", base)):
            hit, idf, rel, err = mxu_agreement(got, ref, any_hit)
            rows.append(f"vs {other}: hits {hit:.6f} ids {idf:.6f} "
                        f"max |dt|/max(1,t) {rel:.3g}")
            if (hit < MXU_TOL["hit_frac"] or idf < MXU_TOL["id_frac"]
                    or rel > MXU_TOL["t_rel"]):
                raise AssertionError(f"stand-in {name}: mxu disagrees with "
                                     f"the {other}: {rows[-1]}")
            if other == "twin":
                stats["err"] = max(stats["err"], err)
        t = dict(walk=cuda_ms(lambda: cs.cluster_walk(*args, **kw)),
                 mxu=cuda_ms(lambda: cs.cluster_walk(*args, mxu=True, **kw)),
                 twin=cuda_ms(lambda: cs.cluster_walk_plain(
                     *args, mxu=True, **kw), reps=1))
        bound = _walk_bound(args, kw, got, mxu=True)
        earlier = (f", earlier {EARLIER_MS['walk_mxu']}"
                   if name == "a_primary" else "")
        log(f"  stand-in mxu {name}: {' | '.join(rows)} | ms K2 "
            f"{t['walk']:.4f} mxu {t['mxu']:.4f} (twin {t['twin']:.3f}"
            f"{earlier})"
            f" {_bound_line(bound, t['mxu'])}")
        if name == "a_primary":
            stats.update(ms=t["mxu"], plain_ms=t["twin"], bound=bound)


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
    check_mxu(tscene, taccel, device, mxu)
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
        from tools.make_large_asset import write_obj
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
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
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
    sys.exit(main())
