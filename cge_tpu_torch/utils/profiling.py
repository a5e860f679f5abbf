"""Profiling and metrics (counterpart of cge_tpu/utils/profiling.py:21-195).

The reference prints its BVH build ms and largest leaf (src/
bounding_volume_hierarchy.cpp:192-193) and each render's ms (main.cpp:
232-236, 532-534). This module keeps those prints and the JAX package's
additions: the count of rays a render dispatches, a profiler scope
(torch.profiler, with the card's activity when there is a card) and a
roofline estimate of the brute-force sweep at the card's peak
(cge_tpu_torch/tools/roofline.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from cge_tpu_torch.tools import roofline


@dataclasses.dataclass
class RenderStats:
    """One render's counters: rays are the primary, shadow and bounce rays
    the wavefront dispatched (count_rays)."""

    wall_ms: float = 0.0
    width: int = 0
    height: int = 0
    primary_rays: int = 0
    total_rays: int = 0

    @property
    def rays_per_s(self) -> float:
        return self.total_rays / (self.wall_ms / 1e3) if self.wall_ms else 0.0

    def __str__(self) -> str:
        return (f"Rendering took {self.wall_ms:.0f} ms "
                f"({self.width}x{self.height}, "
                f"{self.total_rays / 1e6:.2f} Mrays, "
                f"{self.rays_per_s / 1e6:.2f} Mrays/s)")


def count_rays(width: int, height: int, scene, features, params) -> int:
    """The rays a wavefront render dispatches, counted as the JAX package
    counts them: per dispatched closest-hit unit, one closest-hit ray and
    one shadow ray a point light (with soft shadows, the samples of each
    segment and parallelogram light too); MSAA and DoF multiply the
    primary grid. Units a pixel: the chain's levels; the TRANS+REC tree's
    2^d - 1 branch dispatches and 2^d tails of 1 + extra levels (d + 1 +
    extra when all-diffuse); glossy's 1 + rays_per_reflection * d."""
    from cge_tpu_torch.render.wavefront import _unroll_depth

    n = width * height
    if features.enable_multiple_rays_per_pixel:
        n *= params.rays_per_pixel_side ** 2
    if features.enable_depth_of_field:
        n += width * height * params.samples_dof
    shadow = 0
    if features.enable_hard_shadow or features.enable_soft_shadow:
        shadow += sum(scene.point_mask_host)
    if features.enable_soft_shadow:
        shadow += sum(scene.seg_mask_host) * params.segment_light_samples
        shadow += (sum(scene.par_mask_host)
                   * params.parallelogram_light_direction_samples ** 2)

    if features.enable_recursive and features.enable_glossy_reflection:
        units = 1 + params.rays_per_reflection * params.ray_depth
    elif features.enable_recursive and features.enable_transparency:
        d = params.ray_depth
        extra = 0 if scene.all_opaque else params.extra_transparency_unroll
        if scene.all_diffuse:
            units = d + (1 + extra)
        else:
            units = (2 ** d - 1) + 2 ** d * (1 + extra)
    else:
        units = _unroll_depth(scene, params, features)
    return n * (1 + shadow) * units


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_render(scene, camera, features, params, width, height, seed=0):
    """render_image and its RenderStats (the reference's render-ms print,
    main.cpp:232-236, with rays/s); the clock stops after the device has
    finished. Returns (image [H, W, 3] numpy, stats)."""
    from cge_tpu_torch.render.renderer import render_image

    t0 = time.perf_counter()
    img = render_image(scene, camera, features, params, width, height, seed)
    _sync(img.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = RenderStats(
        wall_ms=wall_ms, width=width, height=height,
        primary_rays=width * height,
        total_rays=count_rays(width, height, scene, features, params))
    return img.cpu().numpy(), stats


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler scope over the CPU and, with a card, its CUDA
    activity; on exit the Chrome trace is written into log_dir
    (trace_<pid>_<ns>.json, for chrome://tracing or Perfetto). Yields the
    profiler.

    with profiling.trace("traces"):
        render_image(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# the brute-force sweep's (K3's) operations a (ray, triangle) pair that
# needs its edge tests (tools/roofline.py), each one issue: kernels are
# built without FMA contraction, while the float32 peak counts an FMA as
# two operations, so the card issues FP32_PEAK / 2 of them a second
SWEEP_OPS_PER_PAIR = float(roofline.SWEEP_PLANE_OPS + roofline.SWEEP_EDGE_OPS)
PEAK_SLOTS_PER_S = roofline.FP32_PEAK / 2


def sweep_roofline(n_rays: int, n_tris: int, wall_s: float,
                   peak_flops: float = roofline.FP32_PEAK) -> dict:
    """A roofline estimate of the brute-force sweep on the card, with the
    JAX package's keys: fraction_of_peak (achieved operations over the
    float32 peak), fraction_of_attainable (pairs a second over the issue
    rate / operations a pair) and pairs_per_s. Every pair is counted with
    its edge tests: an upper count of the work."""
    flops = SWEEP_OPS_PER_PAIR * n_rays * n_tris
    achieved = flops / wall_s if wall_s > 0 else 0.0
    pairs_per_s = n_rays * n_tris / wall_s if wall_s > 0 else 0.0
    attainable = PEAK_SLOTS_PER_S / SWEEP_OPS_PER_PAIR
    return dict(
        pair_tests=n_rays * n_tris,
        achieved_flops=achieved,
        fraction_of_peak=achieved / peak_flops,
        pairs_per_s=pairs_per_s,
        slots_per_pair=SWEEP_OPS_PER_PAIR,
        attainable_pairs_per_s=attainable,
        fraction_of_attainable=pairs_per_s / attainable,
    )


@dataclasses.dataclass
class BuildStats:
    """The BVH build's numbers (the reference prints them at
    bounding_volume_hierarchy.cpp:192-193)."""

    build_ms: float
    num_levels: int
    num_leaves: int
    max_per_leaf: int

    def __str__(self) -> str:
        return (f"BVH generation took {self.build_ms:.0f} ms.\n"
                f"Max triangles per node is: {self.max_per_leaf}")


def timed_bvh_build(scene, sah_binning: bool = False):
    """build_reference_bvh and the reference's build prints."""
    from cge_tpu_torch.ops.bvh import build_reference_bvh

    t0 = time.perf_counter()
    bvh = build_reference_bvh(scene, sah_binning=sah_binning)
    ms = (time.perf_counter() - t0) * 1e3
    return bvh, BuildStats(build_ms=ms, num_levels=bvh.num_levels,
                           num_leaves=bvh.num_leaves,
                           max_per_leaf=bvh.max_per_leaf)
