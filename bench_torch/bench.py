#!/usr/bin/env python3
"""The port's benchmark (the counterpart of bench.py, which is the JAX
package's own): BENCHMARK.json's five cells through cge_tpu_torch's entry
points on one card, each output held to a reference made apart from the
port (bench_torch/check.py).

For each cell (bench_torch/cells.py), in BENCHMARK.json's order:

  1. write the stand-in OBJ; for scale512, transrec512 and brute512 start
     the compiled reference renderer (tools/oracle/oracle) on it;
  2. load the scene, then prepare it once (`prepare_render`; a train
     step's rays and target), in seconds, with the peak device memory
     allocated (prepare_peak_mib);
  3. two warm-up calls, in which the bounces' CUDA graphs are captured:
     the peak device memory allocated and reserved over prepare and
     warm-ups (setup_peak_mib, setup_reserved_mib; reserved memory holds
     the graphs' pool) and the graphs held; wait for the oracle, so no
     other process runs in the timed window;
  4. the cell's timed calls (Cell.frames, about 40 s on the card; brute512
     about 110 s), each timed by the host clock around one call that ends
     in torch.cuda.synchronize(): frame_ms (a train step for train128), the
     window's time over its calls, and rays_per_s, all the window's rays
     over all its time; beside them the median, p90 and quartiles of the
     calls, the window's peak device memory allocated and reserved
     (peak_mib, peak_reserved_mib), the graphs held after it and the
     kernels' launches a call;
  5. the last timed call's output against the reference, outside the
     timed window: a cell that fails it reports no time and the run exits
     non-zero;
  6. a separate traced run (PROFILE_FRAMES calls under torch.profiler,
     read through cge_tpu_torch/tools/frame_profile.py and
     bench_torch/attribution.py): the device busy share, the device-op ms
     and ops a call, the ms a call of K1, the sort of its keys (counted by
     its kernels, which a graph replay runs under no host op), K2 and K3,
     the top device ops, and the idle gaps between device work by what
     the host was doing (idle_ms, and idle_over_plain_ms: the unprofiled
     wall less the busy ms, since the profiler slows the host); the
     profiler's kernel counts must equal the launch counters (a trace
     whose counts miss them is taken again, its readings unused, up to
     frame_profile.TRACE_TAKES traces; `trace_misses` lists what each
     missed). One call with eager bounces is traced too: the kernels its
     `aten::sort` ops launch are the sort's sequence, and on that call the
     sort's ms by its kernels must equal the ms of the kernels under
     `aten::sort`, or the run fails (attribution.key_sort);
  7. after the last cell: the run fails if the process has loaded JAX or
     the JAX package (jax_loaded), which the port's benchmark never runs.

The per-layer numbers are the record's `layer_metrics`, under
BENCHMARK.json's names (LAYER_METRICS); `layers` holds the traced run's
details. Every call into the program sits in a record_function span
(prepare, frame, loss_and_grads, sgd_step; bench_torch/cells.py). The
inputs do not depend on --seed (the stand-ins are deterministic, and
soft512's sample key is part of its configuration); the seed is
recorded. --pin CPUS pins
every host thread of the process to those CPUs (the oracle runs on the
others).

    python3 bench_torch/bench.py                        # every cell, card
    python3 bench_torch/bench.py --cell scale512 --frames 30 --seed 0
    python3 bench_torch/bench.py --pin 2,3 --out bench.jsonl

Without a card it stops with a non-zero exit. Each cell prints its lines
and one JSON object; the last line is one JSON object with every cell's
`correct`, frame_ms and rays_per_s (the window's, and the calls' median
and p90), the seed and the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import attribution  # noqa: E402
from bench_torch import cells as bc  # noqa: E402
from bench_torch import check  # noqa: E402
import cge_tpu_torch as ct  # noqa: E402
from cge_tpu_torch.ops import cluster_sweep, stream_probe, sweep  # noqa: E402
from cge_tpu_torch.render import graphs  # noqa: E402
from cge_tpu_torch.tools import frame_profile  # noqa: E402

WARMUP = 2
PROFILE_FRAMES = 3
# each kernel's name in the device trace (the sort of K1's keys, the one
# sort on these cells' paths, is counted by its kernel sequence:
# attribution.key_sort)
KERNELS = {"K1": ("block_entry_keys_kernel",),
           "K2": ("cluster_walk",),
           "K3": ("closest_tris_sweep_kernel", "merge_splits_kernel")}
# the record's layer_metrics: BENCHMARK.json's per-layer metrics
LAYER_METRICS = ("busy_share", "device_ms", "device_ops", "idle_ms",
                 "idle_over_plain_ms", "kernel_ms.K1", "kernel_ms.sort",
                 "kernel_ms.K2", "kernel_ms.K3", "prepare_s",
                 "prepare_peak_mib", "setup_peak_mib", "setup_reserved_mib",
                 "peak_mib", "peak_reserved_mib")
# top-level modules of JAX and of the JAX package, which the port's
# benchmark must not load
JAX_MODULES = ("jax", "jaxlib", "flax", "cge_tpu")
# the launch counter of each kernel's trace names
COUNTERS = {"keys": ("block_entry_keys_kernel",),
            "walk": ("cluster_walk",),
            "sweep": ("closest_tris_sweep_kernel",)}


def _counters():
    return (cluster_sweep.LAUNCHES, sweep.LAUNCHES, stream_probe.LAUNCHES)


def reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def stats(values) -> dict:
    """median, p90, quartiles, min, max and the count of values, and the
    spread: the quartile distance over the median."""
    v = np.asarray(values, dtype=np.float64)
    q1, med, q3, p90 = np.percentile(v, [25, 50, 75, 90])
    return dict(median=float(med), p90=float(p90), q1=float(q1),
                q3=float(q3), min=float(v.min()), max=float(v.max()),
                n=int(v.size), spread=float((q3 - q1) / med))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peaks_mib(device: torch.device) -> tuple:
    """(allocated, reserved) peak device MiB since the last reset; None on
    the CPU. Reserved memory holds the CUDA graphs' pool, which a replay
    does not allocate from anew."""
    if device.type != "cuda":
        return None, None
    return (torch.cuda.max_memory_allocated(device) / 2**20,
            torch.cuda.max_memory_reserved(device) / 2**20)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _release(device: torch.device) -> None:
    """Hand the allocator's cached blocks of earlier cells back, so a
    cell's reserved peak is its own."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def judge(cell: bc.Cell, out, reference, scene) -> dict:
    """The cell's output (a u8 frame, or the train step's loss, gradients
    and stepped scene) against its reference; `ok` decides `correct`.
    scene: the scene the call started from (a train step's steps are the
    stepped leaves less its leaves)."""
    if not cell.train:
        return check.compare_frames(out.cpu().numpy(), reference)
    loss, grads, stepped = out
    start, moved = ct.scene_params(scene), ct.scene_params(stepped)
    return check.compare_train(
        float(loss), {k: g.cpu().numpy() for k, g in grads.items()},
        {k: (moved[k] - start[k]).cpu().numpy() for k in start}, reference)


def window(times, rays: int) -> tuple:
    """frame_ms and rays_per_s of a timed window (ms of each call): the
    window's ms over its calls and all its rays over all its seconds,
    each with the calls' stats."""
    per_call = [rays / (t / 1e3) for t in times]
    return (dict(stats(times), window=float(np.sum(times)) / len(times)),
            dict(stats(per_call),
                 window=rays * len(times) / (float(np.sum(times)) / 1e3)))


def _trace(call, calls: int, device: torch.device) -> tuple:
    """(summary, events): frame_profile.profile_calls' summary of `calls`
    calls of call() after a warm-up call (the unprofiled calls' wall
    beside the profiled ones', the launch counters over the profiled
    calls), taken the same way, with the trace's events, which
    profile_calls does not keep and the idle gaps and the sort need."""
    from torch.profiler import ProfilerActivity, profile

    def calls_ns(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            call()
        _sync(device)
        return time.perf_counter_ns() - t0

    calls_ns(1)
    plain_ns = calls_ns(calls)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    reset_launches()
    with profile(activities=activities) as prof:
        wall_ns = calls_ns(calls)
    events = frame_profile.read_events(prof)
    summary = frame_profile.summarize(events, wall_ns, calls)
    return dict(summary, plain_wall_ms=plain_ns / 1e6 / calls,
                launches=read_launches()), events


def traced_run(cell: bc.Cell, run: bc.Run, device: torch.device,
               calls: int) -> dict:
    """The traced run's per-layer readings (layer_metrics' device part,
    None on the CPU, which has no device events) and details; on the card
    its kernel counts are held to the launch counters (_counted_trace)."""
    prof, events, misses = _counted_trace(cell, run.call, device, calls)
    layers = dict(profiled_calls=calls, wall_ms=prof["wall_ms"],
                  plain_wall_ms=prof["plain_wall_ms"],
                  launches=prof["launches"], trace_misses=misses)
    metrics = dict.fromkeys(("busy_share", "device_ms", "device_ops",
                             "idle_ms", "idle_over_plain_ms")
                            + tuple(f"kernel_ms.{k}"
                                    for k in (*KERNELS, "sort")))
    if device.type != "cuda":
        return dict(metrics=metrics, layers=dict(
            layers, busy_over_plain_wall=None, top_ops=None, idle_gaps=None,
            sort=None))
    for k, names in KERNELS.items():
        metrics[f"kernel_ms.{k}"] = sum(
            op["ms"] for op in prof["ops"]
            if any(name in op["name"] for name in names))
    with graphs._eager_bounces():
        _, eager = _trace(run.call, 1, device)
    sort = attribution.key_sort(events, eager, calls)
    if sort is not None and sort["faults"]:
        raise AssertionError(f"{cell.name}: the key sort by its kernels is "
                             f"not the eager call's aten::sort: "
                             f"{'; '.join(sort['faults'])}")
    metrics["kernel_ms.sort"] = 0.0 if sort is None else sort["ms"]
    idle = attribution.idle_gaps(events, calls)
    busy_ms = prof["busy_ms"]
    metrics.update(
        busy_share=prof["busy_share"], device_ms=prof["device_ms"],
        device_ops=sum(op["count"] for op in prof["ops"]) / calls,
        idle_ms=idle["idle_ms"],
        idle_over_plain_ms=prof["plain_wall_ms"] - busy_ms)
    return dict(metrics=metrics, layers=dict(
        layers, busy_ms=busy_ms,
        busy_over_plain_wall=busy_ms / prof["plain_wall_ms"],
        top_ops=attribution.top_ops(prof), idle_gaps=idle, sort=sort))


def _counted_trace(cell: bc.Cell, call, device: torch.device,
                   calls: int) -> tuple:
    """(summary, events, misses): _trace's reading of `calls` calls, on
    the card one whose kernel counts equal the launch counters
    (_launch_misses), taken up to frame_profile.TRACE_TAKES times; misses
    lists what each discarded take missed. The run fails if every take
    misses."""
    misses = []
    while True:
        prof, events = _trace(call, calls, device)
        if device.type != "cuda":
            return prof, events, misses
        miss = _launch_misses(cell, prof["launches"], prof)
        if not miss:
            return prof, events, misses
        misses.append(miss)
        if len(misses) == frame_profile.TRACE_TAKES:
            raise AssertionError(f"{cell.name}: in each of {len(misses)} "
                                 f"traces {'; '.join(misses)}")


def _launch_misses(cell: bc.Cell, launches: dict, prof: dict) -> str:
    """On the card: raise unless the cell's kernels ran (K1 and K2 with
    the accel, K3 without) and no other did; then what the profiler
    counted apart from each kernel's launch counter over the traced
    calls ("" when every count is equal)."""
    want = (("keys", "walk") if cell.features.get("enable_accel_structure")
            else ("sweep",))
    if any(launches[k] <= 0 for k in want) or any(
            launches[k] for k in set(COUNTERS) - set(want)):
        raise AssertionError(f"{cell.name}: launches {launches}, want "
                             f"{want}")
    misses = []
    for k, names in COUNTERS.items():
        seen = sum(op["count"] for op in prof["ops"]
                   if any(name in op["name"] for name in names))
        if seen != prof["launches"][k]:
            misses.append(f"the profiler counted {seen} {k} kernels, the "
                          f"counter {prof['launches'][k]}")
    return ", ".join(misses)


def run_cell(cell: bc.Cell, device, tmp: str, *, frames: int | None = None,
             warmup: int = WARMUP, profile_frames: int = PROFILE_FRAMES,
             reference=None, oracle_cpus=None, log=print) -> dict:
    """One cell on `device` (cuda: the kernels; cpu: their plain twins,
    for a rehearsal at a toy size), its files in tmp: the result record.
    frames: the timed calls (the cell's own by default). frame_ms and
    rays_per_s are None when the output fails its check. reference: a JAX
    cell's reference (jax_references/make_references.py `outputs`) in
    place of the stored one, for a cell at another size. oracle_cpus: the
    host CPUs of the oracle's process."""
    device = torch.device(device)
    frames = frames or cell.frames
    _release(device)
    obj = bc.obj_path(cell, tmp)
    t0 = time.perf_counter()
    bc.write_scene(cell, obj)
    write_s = time.perf_counter() - t0
    oracle = raw = None
    if cell.reference == "oracle":
        raw = os.path.splitext(obj)[0] + "_oracle.raw"
        oracle = check.start_oracle(cell, obj, raw, oracle_cpus)
    t0 = time.perf_counter()
    scene = bc.load(cell, obj, device)
    _sync(device)
    load_s = time.perf_counter() - t0
    _reset_peak(device)
    run = bc.setup(cell, scene, device)
    prepare_peak, _ = _peaks_mib(device)
    for _ in range(warmup):
        run.call()
    _sync(device)
    setup_peak, setup_reserved = _peaks_mib(device)
    graphs_after_setup = graphs.graphs_held()
    t0 = time.perf_counter()
    if oracle is not None:
        reference = check.finish_oracle(oracle, raw, cell.side)
    else:
        ref = reference or check.load_reference(cell)
        reference = ref if cell.train else ref["frame"]
    oracle_wait_s = time.perf_counter() - t0

    reset_launches()
    _reset_peak(device)
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = run.call()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    peak, peak_reserved = _peaks_mib(device)
    graphs_after_window = graphs.graphs_held()
    launches = {k: v / frames for k, v in read_launches().items()}
    verdict = judge(cell, out, reference, scene)
    del out

    traced = traced_run(cell, run, device, profile_frames)
    ok = bool(verdict["ok"])
    frame_ms, rays_per_s = window(times, run.rays)
    metrics = dict(traced["metrics"], prepare_s=run.prepare_s,
                   prepare_peak_mib=prepare_peak, setup_peak_mib=setup_peak,
                   setup_reserved_mib=setup_reserved, peak_mib=peak,
                   peak_reserved_mib=peak_reserved)
    result = dict(
        cell=cell.name, config=cell.config, correct=ok, check=verdict,
        device=device.type, frames=frames, warmup=warmup,
        rays_per_call=run.rays, trace_chunk=cell.params["trace_chunk"],
        frame_ms=frame_ms if ok else None,
        rays_per_s=rays_per_s if ok else None,
        times_ms=times if ok else None,
        setup=dict(write_s=write_s, load_s=load_s,
                   oracle_wait_s=oracle_wait_s),
        graphs=dict(after_setup=graphs_after_setup,
                    after_window=graphs_after_window),
        launches_per_call=launches,
        layer_metrics={k: metrics[k] for k in LAYER_METRICS},
        layers=traced["layers"])
    log_cell(result, log)
    return result


def _fmt(x, spec=".4f") -> str:
    return "not measured" if x is None else format(x, spec)


def log_cell(r: dict, log=print) -> None:
    """A cell's result as printed lines."""
    unit = "step" if bc.BY_NAME[r["cell"]].train else "frame"
    c = r["check"]
    what = (f"loss {c['loss']:.7g} (JAX {c['loss_jax']:.7g}, rel "
            f"{c['loss_rel']:.3g}), worst gradient rel "
            f"{c['worst_grad']:.3g}, worst step rel {c['worst_step']:.3g}"
            if "loss" in c else
            f"{c['close_share']:.4%} of pixels within 1 level, 99.99th "
            f"pct |diff| {c['tail_levels']:g} levels")
    log(f"{r['cell']} ({r['config']}, {r['device']}): correct "
        f"{r['correct']}: {what}")
    if r["frame_ms"] is not None:
        f, q = r["frame_ms"], r["rays_per_s"]
        log(f"  {unit}_ms {f['window']:.3f} over the window; calls: "
            f"median {f['median']:.3f} p90 {f['p90']:.3f} (q1 {f['q1']:.3f} "
            f"q3 {f['q3']:.3f}, spread {f['spread']:.4f}, n {f['n']}); "
            f"rays_per_s {q['window']:.6g} over the window (calls' median "
            f"{q['median']:.6g}, p90 {q['p90']:.6g}); {r['rays_per_call']} "
            f"rays a {unit}")
    s, m, ly, g = r["setup"], r["layer_metrics"], r["layers"], r["graphs"]
    log(f"  set-up: write {s['write_s']:.2f} s, load {s['load_s']:.2f} s, "
        f"prepare {m['prepare_s']:.3f} s, oracle wait "
        f"{s['oracle_wait_s']:.2f} s; peak MiB allocated / reserved: "
        f"prepare {_fmt(m['prepare_peak_mib'], '.0f')}, set-up with the "
        f"warm-ups {_fmt(m['setup_peak_mib'], '.0f')} / "
        f"{_fmt(m['setup_reserved_mib'], '.0f')}, timed window "
        f"{_fmt(m['peak_mib'], '.0f')} / "
        f"{_fmt(m['peak_reserved_mib'], '.0f')}; graphs held after set-up "
        f"{g['after_setup']}, after the window {g['after_window']}; "
        f"launches a {unit} {r['launches_per_call']}")
    kernels = ", ".join(f"{k.split('.')[1]} {_fmt(v, '.3f')}"
                        for k, v in m.items() if k.startswith("kernel_ms."))
    log(f"  traced ({ly['profiled_calls']} calls): busy share "
        f"{_fmt(m['busy_share'])}, busy ms over the unprofiled wall "
        f"{_fmt(ly['busy_over_plain_wall'])}, device-op ms a {unit} "
        f"{_fmt(m['device_ms'], '.3f')}, device ops a {unit} "
        f"{_fmt(m['device_ops'], '.1f')}, idle ms a {unit} "
        f"{_fmt(m['idle_ms'], '.3f')} traced, "
        f"{_fmt(m['idle_over_plain_ms'], '.3f')} over the unprofiled wall; "
        f"kernel ms a {unit}: {kernels}")
    for miss in ly.get("trace_misses") or ():
        log(f"  a trace taken again, its readings unused: {miss}")
    if ly["sort"] is not None:
        sort, eager = ly["sort"], ly["sort"]["eager"]
        log(f"  key sort: {len(sort['kernels'])} kernels a "
            f"sort, {sort['sorts']:.1f} sorts a {unit}; eager bounces: "
            f"{eager['by_kernels_ms']:.4f} ms by its kernels "
            f"({eager['by_kernels_sorts']:.1f} sorts), "
            f"{eager['aten_sort_ms']:.4f} ms under aten::sort "
            f"({eager['aten_sorts']:.1f}); counted kernels outside "
            f"aten::sort: "
            f"{eager['outside_aten_sort'] or 'none'}")
    if ly["top_ops"] is not None:
        log(f"  top device ops: ms a {unit} | count a {unit} | share")
        for op in ly["top_ops"]:
            log(f"    {op['ms']:9.4f} | {op['count']:8.1f} | "
                f"{op['share']:.4f} | {op['name'][:100]}")
        idle = ly["idle_gaps"]
        log(f"  idle gaps by host activity (traced): {idle['idle_ms']:.3f} "
            f"ms in {idle['gaps']:.1f} gaps a {unit} of a "
            f"{idle['window_ms']:.3f} ms window; ms a {unit} | gaps a "
            f"{unit} | longest ms")
        for gap in idle["by_host"]:
            log(f"    {gap['ms']:9.4f} | {gap['gaps']:8.1f} | "
                f"{gap['longest_ms']:.4f} | {gap['name'][:100]}")


def pin_threads(cpus) -> set:
    """Pin every thread of this process (and those it starts later) to
    the host CPUs `cpus`; the allowed CPUs that are left."""
    cpus = set(cpus)
    left = os.sched_getaffinity(0) - cpus
    for tid in os.listdir("/proc/self/task"):
        os.sched_setaffinity(int(tid), cpus)
    torch.set_num_threads(len(cpus))
    return left


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi: {smi.stderr.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", choices=list(bc.BY_NAME),
                    help="a cell to run (repeatable; every cell by default)")
    ap.add_argument("--frames", type=int,
                    help="timed calls a cell (the cell's own by default, "
                         "about 40 s on the card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="recorded; no input depends on it")
    ap.add_argument("--out", help="also append each cell's JSON here")
    ap.add_argument("--pin", help="host CPUs (e.g. 2,3) to pin the "
                    "process's threads to; the oracle runs on the others")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false); "
              "the benchmark runs on the card only", flush=True)
        return 1
    from cge_tpu_torch import _kernels

    pinned = sorted(int(c) for c in args.pin.split(",")) if args.pin else None
    oracle_cpus = pin_threads(pinned) if pinned else None
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    kind, smi = torch.cuda.get_device_name(0), card_line()
    print(f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | seed {args.seed} | host CPUs "
          f"{pinned or 'unpinned'}", flush=True)
    lib = _kernels.library()
    print(f"kernels built in {lib.build_seconds:.1f} s", flush=True)
    chosen = [c for c in bc.CELLS if not args.cell or c.name in args.cell]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for cell in chosen:
            r = dict(run_cell(cell, device, tmp, frames=args.frames,
                              oracle_cpus=oracle_cpus,
                              log=lambda m: print(m, flush=True)),
                     seed=args.seed, card=kind, smi=smi, pinned=pinned)
            print(json.dumps(r), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
            results.append(r)
    loaded = jax_loaded()
    if loaded:
        print(f"FAIL: the process loaded {', '.join(loaded)}; the port's "
              f"benchmark runs without JAX", flush=True)
    line = last_line(results, args.seed, pinned, smi, kind,
                     torch.cuda.device_count(), loaded)
    print(json.dumps(line), flush=True)
    return 0 if line["ok"] else 1


def jax_loaded(modules=None) -> list:
    """The modules of JAX_MODULES (or below them) among `modules`
    (sys.modules by default)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in JAX_MODULES)


def last_line(results, seed, pinned, smi, kind, count, loaded) -> dict:
    """The run's last line: every cell's `correct`, frame_ms and
    rays_per_s (the window's, and the calls' median and p90); `ok` holds
    when every cell is correct and `loaded` (jax_loaded) is empty."""
    correct = all(r["correct"] for r in results)
    return {
        "ok": correct and not loaded, "correct": correct, "seed": seed,
        "pinned": pinned,
        "cells": {r["cell"]: {
            "correct": r["correct"], "frames": r["frames"],
            **{f"{m}{suffix}": r[m] and r[m][stat]
               for m in ("frame_ms", "rays_per_s")
               for suffix, stat in (("", "window"), ("_median", "median"),
                                    ("_p90", "p90"))}}
            for r in results},
        "smi": smi,
        "device": {"platform": "gpu", "kind": kind, "count": count}}


if __name__ == "__main__":
    raise SystemExit(main())
