"""Debug views as arrays and images (see cge_tpu_torch.viz.debug)."""

from cge_tpu_torch.viz.debug import (DebugRays, ShadowRays, aabb_segments,
                                     debug_shadow_rays, debug_trace,
                                     draw_segments, normal_segments,
                                     project_points)

__all__ = [
    "DebugRays", "ShadowRays", "aabb_segments", "debug_shadow_rays",
    "debug_trace", "draw_segments", "normal_segments", "project_points",
]
