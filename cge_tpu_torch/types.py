"""Core static configuration types (counterpart of cge_tpu/types.py).

`Features` and `RenderParams` carry the same fields and defaults as the JAX
package, so configs carry across unchanged. `check_supported` raises for a
`prims_axis` that names no axis of a mesh bound by a sharded entry point
(cge_tpu_torch.parallel), as JAX fails on an axis name outside
`shard_map`.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class Features:
    """Feature flags (reference src/common.h:54-77), flat layout."""

    enable_shading: bool = False
    enable_recursive: bool = False
    enable_hard_shadow: bool = False
    enable_soft_shadow: bool = False
    enable_normal_interp: bool = False
    enable_texture_mapping: bool = False
    enable_accel_structure: bool = False
    enable_environment_mapping: bool = False
    enable_bvh_sah_binning: bool = False
    enable_motion_blur: bool = False
    enable_bloom_effect: bool = False
    enable_bilinear_texture_filtering: bool = False
    enable_mipmap_texture_filtering: bool = False
    enable_multiple_rays_per_pixel: bool = False
    enable_glossy_reflection: bool = False
    enable_transparency: bool = False
    enable_depth_of_field: bool = False

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_nested(cls, base: dict, extra: dict | None = None) -> "Features":
        """Build from the reference's nested camelCase layout
        (common.h:54-77): `base` maps the seven Features members, `extra`
        the ExtraFeatures members (or pass base['extra']). An unknown flag
        raises KeyError."""
        merged = dict(base)
        nested = merged.pop("extra", None)
        if extra is None:
            extra = nested or {}
        merged.update(extra)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in merged.items():
            s = re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower()
            if s not in fields:
                raise KeyError(f"unknown feature flag: {k!r}")
            kw[s] = bool(v)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Render parameters; see cge_tpu/types.py for what each one tunes."""

    ray_depth: int = 5
    rays_per_pixel_side: int = 3
    samples_dof: int = 5
    focus_plane_distance: float = 3.0
    blur_strength: float = 0.005
    bloom_scalar: float = 0.3
    bloom_threshold: float = 0.4
    bloom_debug_option: int = 0
    glossy_reflections_cap: int = 3
    rays_per_reflection: int = 40
    alpha_modifier: float = 1.0
    segment_light_samples: int = 25
    parallelogram_light_direction_samples: int = 5
    extra_transparency_unroll: int = 6
    ray_tile: int = 2048
    trace_chunk: int = 65536
    tri_tile: int = 512
    sweep_br: int = 512
    sweep_exact_keys: bool = True
    sweep_anyhit_exact_keys: bool = True
    sweep_shared_origin: bool = True
    sweep_sc_n: int | None = None
    sweep_anyhit_sc_n: int | None = None
    sweep_sort_bounce: bool | None = None
    sweep_sort_shadow: bool | None = None
    sweep_shadow_reverse: bool = True
    prims_axis: str | None = None
    prims_axis_size: int = 1

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)


def check_supported(params: RenderParams) -> None:
    """Raise ValueError for a prims_axis set outside a sharded entry point:
    the axis must name an axis of the mesh that parallel.sharding binds,
    of size prims_axis_size. Every feature flag that changes the JAX
    package's render renders here; the flags that change nothing there
    (environment mapping, motion blur, SAH binning, the texture filter
    modes without texture mapping) change nothing here either."""
    if params.prims_axis is None:
        return
    from cge_tpu_torch.parallel.comm import mesh_axis

    axis = mesh_axis(params.prims_axis)
    if axis.size != params.prims_axis_size:
        raise ValueError(f"prims_axis {params.prims_axis!r} has "
                         f"{axis.size} ranks, prims_axis_size says "
                         f"{params.prims_axis_size}")


DEFAULT_FEATURES = Features()
DEFAULT_PARAMS = RenderParams()
