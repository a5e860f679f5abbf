"""Core static configuration types (counterpart of cge_tpu/types.py).

`Features` and `RenderParams` carry the same fields and defaults as the JAX
package, so configs carry across unchanged. Knobs that only the JAX path
implements are still accepted as fields; `check_supported` names the ones
this port cannot honour yet and raises for them, so no flag is silently
ignored.
"""

from __future__ import annotations

import dataclasses


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


# feature flag -> the ROADMAP.md item (section 1, "Modules to port") that
# ports it. Flags that change nothing in the JAX package's render are not
# listed and change nothing here either: environment mapping and motion
# blur (no code path in either package), SAH binning (it shapes only the
# reference BVH of the debug views), and the texture filter modes, which
# act only under enable_texture_mapping.
_UNPORTED_FEATURES = {
    "enable_texture_mapping": "texture (ROADMAP 1.1)",
    "enable_soft_shadow": "stochastic features (ROADMAP 1.2)",
    "enable_bloom_effect": "bloom (ROADMAP 1.3)",
    "enable_multiple_rays_per_pixel": "MSAA/DoF (ROADMAP 1.4)",
    "enable_depth_of_field": "MSAA/DoF (ROADMAP 1.4)",
    "enable_glossy_reflection": "glossy (ROADMAP 1.6)",
}


def check_supported(features: Features, params: RenderParams) -> None:
    """Raise NotImplementedError for any flag or knob outside the port."""
    for name, item in _UNPORTED_FEATURES.items():
        if getattr(features, name):
            raise NotImplementedError(f"{name}: not ported yet, see {item}")
    if features.enable_transparency and features.enable_recursive:
        raise NotImplementedError(
            "transparency + recursive (TRANS+REC tree): see ROADMAP 1.5")
    if params.prims_axis is not None:
        raise NotImplementedError("prims_axis: multi-device, ROADMAP 1.8")
