"""Per-op device attribution of a frame (the port's counterpart of
tools/xprof_dragon.py, tools/xprof_render.py, tools/xplane_summary.py and
tools/profile_bench.py).

`run` builds the scene of chip_smoke.py's phase 3 (`dragon`: scale512,
the 614,400-triangle stand-in with the headline features and the accel)
or phase 6 (`brute`: brute512, the 15,360-triangle stand-in with the
accel off), prepares the context once and hands it to `profile_frames`,
which renders a warm-up frame, times N frames by the host clock to a
synchronize, then renders N more under torch.profiler (CPU and, on the
card, CUDA activity) and reads:

  - the profiled frames' wall ms, by the host clock to a synchronize;
  - the device-op ms a frame: the sum of the device events' durations
    (kernels, copies and fills);
  - the device busy share: the union of those events' intervals over the
    frames' window, divided by the window's wall (overlapping events count
    once); the idle share is 1 - busy. The profiler slows the host, so
    the busy ms over the unprofiled wall is printed beside it;
  - the top ops by device self time, with their count a frame and share;
  - the device time under each record_function label the render path
    sets (LABELS: ops/rng.py's draws, ops/texture.py's texel lookups,
    render/bloom.py);
  - the kernels' launch counters over the profiled frames.

The parse is pure: `read_events` turns a profile into Event tuples, and
`busy_ns`, `summarize` and `plain_ops` read those, so tests/
test_torch_frame_profile.py runs it without a card. On the CPU there are
no device events and the busy share is 0.

    python -m cge_tpu_torch.tools.frame_profile --scene dragon   # the card
    python -m cge_tpu_torch.tools.frame_profile --scene brute --frames 5
    python -m cge_tpu_torch.tools.frame_profile --scene brute \\
        --device cpu --size 32 --grid 9 8 --frames 1             # tiny, CPU
"""

from __future__ import annotations

import argparse
import bisect
import time
from typing import NamedTuple

import torch

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.ops import cluster_sweep, rng, stream_probe, sweep, texture
from cge_tpu_torch.render import bloom
from cge_tpu_torch.render.renderer import prepare_render, render_image_u8
from cge_tpu_torch.tools import common
from cge_tpu_torch.types import Features, RenderParams

HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True)
# name -> (stand-in grid, features, render params): chip_smoke.py's
# phase 3 and phase 6 frames
SCENES = {
    "dragon": (common.DRAGON_GRID, dict(HEADLINE, enable_accel_structure=True),
               dict(sweep_sc_n=1, sweep_anyhit_sc_n=1, trace_chunk=16384)),
    "brute": (common.TEAPOT_GRID, HEADLINE, {}),
}
# traces of the same calls, at most, where a reader holds the profiler's
# kernel counts to the launch counters: torch.profiler's CUDA activity now
# and then loses a kernel's record (one K1 of transrec512's 74 in one
# chip_smoke.py run; none in 40 traces of the same frame in one process),
# so a trace that misses a counter is taken again and its readings are
# not used, and the reader fails only if every take misses
TRACE_TAKES = 3
# record_function label -> the part of a frame it names
LABELS = {rng.LABELS["uniform"]: "threefry",
          rng.LABELS["per_ray_uniform"]: "threefry per ray",
          texture.LABEL: "texels", bloom.LABEL: "bloom"}


class Event(NamedTuple):
    """One event of a torch.profiler trace."""

    name: str
    device: bool        # on the card (kernels, copies, fills, annotations)
    annotation: bool    # a record_function span (on the host or the card)
    start_ns: int
    dur_ns: int
    thread: int
    corr: int           # its correlation id
    linked: int         # the id it links to (device work: its host op's)
    is_async: bool

    @property
    def work(self) -> bool:
        """A kernel, copy or fill: a device event that is no annotation.
        (A kernel launched outside every torch op, as the port's kernels
        are, links to no op.)"""
        return self.device and not self.annotation


def read_events(prof) -> list:
    """The Event tuples of a finished torch.profiler profile, from its raw
    kineto events (its own parse of a 512x512 frame takes seconds)."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() != DeviceType.CPU,
                  e.is_user_annotation(), e.start_ns(), e.duration_ns(),
                  e.start_thread_id(), e.correlation_id(),
                  e.linked_correlation_id(), e.is_async())
            for e in prof.profiler.kineto_results.events()]


def busy_ns(intervals) -> int:
    """The length of the union of [start, end) intervals: overlapping and
    nested intervals count once, gaps not at all."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is not None and end <= reach:
            continue
        total += end - (start if reach is None else max(start, reach))
        reach = end
    return total


def plain_ops(events, labels) -> dict:
    """name -> (calls, device ms, kernels) of each labelled part: a host op
    that starts inside a label's span, on its thread, owns the device
    events (kernels, copies, fills) whose linked correlation id is its
    correlation id. Only ops own: an event linked to an op (a CUDA runtime
    call) has a correlation id of another count, which may equal an
    op's."""
    cpu = [e for e in events
           if not e.device and not e.is_async and not e.linked]
    spans = sorted((e.start_ns, e.start_ns + e.dur_ns, e.thread,
                    labels[e.name]) for e in cpu if e.name in labels)
    starts = [s[0] for s in spans]
    owner = {}
    for e in cpu:
        i = bisect.bisect_right(starts, e.start_ns) - 1
        if i >= 0 and e.start_ns < spans[i][1] and e.thread == spans[i][2]:
            owner[e.corr] = spans[i][3]
    out = {name: [0, 0.0, 0] for name in labels.values()}
    for span in spans:
        out[span[3]][0] += 1
    for e in events:
        if e.device:
            name = owner.get(e.linked)
            if name is not None:
                out[name][1] += e.dur_ns / 1e6
                out[name][2] += 1
    return {k: tuple(v) for k, v in out.items()}


def summarize(events, wall_ns: int, frames: int = 1,
              labels: dict | None = None) -> dict:
    """The frames' summary from their events and the wall of their window:
    wall and device-op ms a frame, the busy share, every device op (name,
    ms a frame, count over the frames, share of the device-op time; by
    time, then name) and the labelled parts a frame (plain_ops)."""
    work = [e for e in events if e.work]
    device_ns = sum(e.dur_ns for e in work)
    by_name = {}
    for e in work:
        row = by_name.setdefault(e.name, [0, 0])
        row[0] += e.dur_ns
        row[1] += 1
    ops = [dict(name=name, ms=ns / 1e6 / frames, count=n,
                share=ns / device_ns)
           for name, (ns, n) in sorted(by_name.items(),
                                       key=lambda kv: (-kv[1][0], kv[0]))]
    busy = busy_ns((e.start_ns, e.start_ns + e.dur_ns) for e in work)
    parts = plain_ops(events, LABELS if labels is None else labels)
    return dict(frames=frames, wall_ms=wall_ns / 1e6 / frames,
                device_ms=device_ns / 1e6 / frames,
                busy_ms=busy / 1e6 / frames,
                busy_share=busy / wall_ns if wall_ns else 0.0, ops=ops,
                labels={k: (c / frames, ms / frames, n / frames)
                        for k, (c, ms, n) in parts.items()})


def kernel_count(summary: dict, name: str) -> int:
    """Device events over the profiled frames whose name holds `name`."""
    return sum(op["count"] for op in summary["ops"] if name in op["name"])


def _launches() -> dict:
    return {k: v for counts in (cluster_sweep.LAUNCHES, sweep.LAUNCHES,
                                stream_probe.LAUNCHES)
            for k, v in counts.items()}


def _frames(render, n: int, dev: torch.device) -> int:
    """Host ns of n frames, to a synchronize on the card."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        render()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter_ns() - t0


def profile_calls(call, calls: int, dev: torch.device,
                  labels: dict | None = None) -> dict:
    """summarize's summary of `calls` calls of call() after a warm-up
    call, with the unprofiled calls' wall ms a call (`plain_wall_ms`) and
    the launch counters' increase over the profiled calls (`launches`).
    A call is a frame or a train step; the host waits for the device once,
    after the last call. labels: summarize's (LABELS by default)."""
    from torch.profiler import ProfilerActivity, profile

    _frames(call, 1, dev)
    plain_ns = _frames(call, calls, dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = _launches()
    with profile(activities=activities) as prof:
        wall_ns = _frames(call, calls, dev)
    launches = {k: v - before[k] for k, v in _launches().items()}
    summary = summarize(read_events(prof), wall_ns, calls, labels)
    return dict(summary, plain_wall_ms=plain_ns / 1e6 / calls,
                launches=launches, device=dev.type)


def profile_frames(scene, features, params, size: int, frames: int = 3, *,
                   ctx=None, seed: int = 0) -> dict:
    """profile_calls over `frames` size x size render_image_u8 frames of
    scene. ctx: a prepared context, else one is prepared here."""
    dev = scene.vertices.device
    if ctx is None:
        ctx = prepare_render(scene, features, params)

    def render():
        render_image_u8(scene, Camera(), features, params, size, size, seed,
                        ctx=ctx)

    return profile_calls(render, frames, dev)


def run(scene: str, frames: int = 3, size: int = 512, device: str = "cuda",
        grid=None) -> dict:
    """profile_frames on a named scene of SCENES, its stand-in at `grid`
    (the scene's own by default) on `device`; a CUDA device without a card
    stops with SystemExit."""
    dev = common.device_from(device)
    own_grid, feats, params = SCENES[scene]
    s = common.standin_scene(tuple(grid or own_grid), dev)
    out = profile_frames(s, Features(**feats), RenderParams(**params), size,
                         frames)
    return dict(out, title=f"{scene} {size}x{size}",
                card=common.card_line(dev))


def report(summary: dict, top: int = 20) -> list:
    """The summary as printed lines, headed by its `title`."""
    f = summary["frames"]
    busy = summary["busy_share"]
    lines = [
        f"{summary.get('title', 'frame')}: {f} profiled frames, wall {summary['wall_ms']:.2f} ms a frame "
        f"(host clock to a synchronize; unprofiled "
        f"{summary['plain_wall_ms']:.2f} ms)",
        (f"device-op ms a frame {summary['device_ms']:.2f}, busy "
         f"{summary['busy_ms']:.2f}: busy share {busy:.4f}, idle share "
         f"{1 - busy:.4f} (of the profiled frames; busy ms over the "
         f"unprofiled wall "
         f"{summary['busy_ms'] / summary['plain_wall_ms']:.4f})"
         if summary.get("device") == "cuda" else
         "device-op ms, busy and idle share: not measured (no card)"),
        f"launches over the profiled frames: {summary['launches']}",
        "top ops by device self time: ms a frame | count a frame | share"]
    lines += [f"  {op['ms']:10.4f} | {op['count'] / f:8.1f} | "
              f"{op['share']:.4f} | {op['name'][:100]}"
              for op in summary["ops"][:top]]
    lines.append("labelled parts: calls | device ms | kernels, a frame")
    lines += [f"  {name}: {c:.1f} | {ms:.4f} | {n:.1f}"
              for name, (c, ms, n) in summary["labels"].items()]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), required=True)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, default=512,
                    help="the frame's width and height")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, device events) or cpu (the "
                         "plain twins, no device events)")
    ap.add_argument("--grid", type=int, nargs=2, default=None,
                    metavar=("RINGS", "SEGS"),
                    help="the stand-in's grid (the scene's own by default)")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    summary = run(args.scene, args.frames, args.size, args.device, args.grid)
    print(summary["card"])
    for line in report(summary, args.top):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
