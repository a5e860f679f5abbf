"""TOML config files (counterpart of cge_tpu/config.py:43-218).

readConfigFile (the reference's src/config.cpp:193-374) on the standard
library's tomllib, with the JAX package's keys, defaults and quirks:

  - `command_line_rendering` (default true), `window_size` [w, h] (default
    [800, 800]), `data_path` ("default" or absent: DEFAULT_DATA_DIR, which
    the port leaves empty, so a prebuilt scene read from it fails to load);
  - `scene`: an integer SceneType, a scene name, or an .obj path relative
    to data_path that must exist (a missing file exits 1);
  - `output_dir` with `~` and `$HOME` expanded; empty means the current
    directory, with a warning;
  - `[features]` / `[features.extra]` booleans. The reference never reads
    `enable_soft_shadow`, `enable_transparency` or
    `enable_bvh_sah_binning` from the file, so neither does this parser:
    they are reachable through the API only;
  - `[[cameras]]`: field_of_view and rotation in degrees,
    distance_from_look_at, look_at;
  - `[[lights]]`: point, segment and parallelogram with the reference's
    key names; an unknown type warns and is skipped; no lights warns.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tomllib
from typing import List, Sequence, Union

import numpy as np

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.scene.scene import (DEFAULT_DATA_DIR, Light,
                                       ParallelogramLight, PointLight,
                                       SceneType, SegmentLight,
                                       deserialize_scene_type,
                                       serialize_scene_type)
from cge_tpu_torch.types import Features


@dataclasses.dataclass
class CameraConfig:
    """src/config.h:16-21 (angles in degrees, like the file format)."""

    field_of_view: float = 50.0
    distance_from_look_at: float = 3.0
    look_at: Sequence[float] = (0.0, 0.0, 0.0)
    rotation: Sequence[float] = (20.0, 20.0, 0.0)

    def to_camera(self, aspect: float = 1.0) -> Camera:
        """Degrees -> radians conversion done at src/main.cpp:518-519."""
        return Camera(
            fovy=float(np.radians(self.field_of_view)),
            distance=float(self.distance_from_look_at),
            look_at=tuple(float(v) for v in self.look_at),
            rotation=tuple(float(np.radians(v)) for v in self.rotation),
            aspect=aspect,
        )


@dataclasses.dataclass
class Config:
    """src/config.h:23-33."""

    features: Features = dataclasses.field(default_factory=Features)
    cli_rendering_enabled: bool = False
    window_size: Sequence[int] = (800, 800)
    data_path: str = DEFAULT_DATA_DIR
    scene: Union[SceneType, str] = SceneType.SingleTriangle
    output_dir: str = ""
    cameras: List[CameraConfig] = dataclasses.field(default_factory=list)
    lights: List[Light] = dataclasses.field(default_factory=list)

    def __str__(self) -> str:
        """Config echo (operator<<, config.cpp:71-145)."""
        lines = ["Config:"]
        scene_name = (serialize_scene_type(self.scene)
                      if isinstance(self.scene, SceneType)
                      else str(self.scene))
        lines.append(f"  cli_rendering: {self.cli_rendering_enabled}")
        lines.append(f"  window_size: {tuple(self.window_size)}")
        lines.append(f"  data_path: {self.data_path}")
        lines.append(f"  scene: {scene_name}")
        lines.append(f"  output_dir: {self.output_dir}")
        for f in dataclasses.fields(Features):
            v = getattr(self.features, f.name)
            if v:
                lines.append(f"  feature {f.name}: {v}")
        for i, c in enumerate(self.cameras):
            lines.append(
                f"  camera {i}: fov={c.field_of_view} deg, "
                f"dist={c.distance_from_look_at}, look_at={tuple(c.look_at)}, "
                f"rotation={tuple(c.rotation)} deg")
        for i, l in enumerate(self.lights):
            lines.append(f"  light {i}: {type(l).__name__}")
        return "\n".join(lines)


def _vec3(node, default=(0.0, 0.0, 0.0)):
    if isinstance(node, (list, tuple)) and len(node) == 3:
        return tuple(float(v) for v in node)
    return tuple(float(v) for v in default)


def read_config_file(path: str) -> Config:
    with open(path, "rb") as f:
        table = tomllib.load(f)

    config = Config()
    config.cli_rendering_enabled = bool(
        table.get("command_line_rendering", True))          # config.cpp:205

    ws = table.get("window_size")
    if isinstance(ws, (list, tuple)) and len(ws) == 2:
        config.window_size = (int(ws[0]), int(ws[1]))
    else:
        config.window_size = (800, 800)

    data_path = table.get("data_path", DEFAULT_DATA_DIR)
    if data_path == "default":  # config.cpp:211-213
        data_path = DEFAULT_DATA_DIR
    config.data_path = str(data_path)

    scene = table.get("scene", "none")
    if isinstance(scene, int):  # config.cpp:217-219
        config.scene = SceneType(scene)
    else:
        st = deserialize_scene_type(str(scene))
        if st is not None:
            config.scene = st
        else:
            full = os.path.join(config.data_path, str(scene))
            if os.path.exists(full):  # config.cpp:227-229
                config.scene = full
            else:
                print(f"Error: Scene file {full} does not exist.",
                      file=sys.stderr)
                sys.exit(1)  # config.cpp:231-233

    output_dir = str(table.get("output_dir", ""))
    if not output_dir:  # config.cpp:238-241
        print("Warning: No output directory specified, using current "
              "directory.")
        config.output_dir = os.getcwd()
    else:
        home = os.environ.get("HOME", "")
        if output_dir.startswith("~"):  # config.cpp:245-247
            output_dir = home + output_dir[1:]
        if output_dir.startswith("$HOME"):  # config.cpp:249-251
            output_dir = home + output_dir[5:]
        config.output_dir = os.path.abspath(output_dir)

    feats = table.get("features", {})
    extra = feats.get("extra", {}) if isinstance(feats, dict) else {}
    config.features = Features(
        enable_shading=bool(feats.get("enable_shading", False)),
        enable_recursive=bool(feats.get("enable_recursive", False)),
        enable_hard_shadow=bool(feats.get("enable_hard_shadow", False)),
        enable_normal_interp=bool(feats.get("enable_normal_interp", False)),
        enable_texture_mapping=bool(
            feats.get("enable_texture_mapping", False)),
        enable_accel_structure=bool(
            feats.get("enable_accel_structure", False)),
        enable_bloom_effect=bool(extra.get("enable_bloom_effect", False)),
        enable_multiple_rays_per_pixel=bool(
            extra.get("enable_multiple_rays_per_pixel", False)),
        enable_motion_blur=bool(extra.get("enable_motion_blur", False)),
        enable_depth_of_field=bool(extra.get("enable_depth_of_field", False)),
        enable_glossy_reflection=bool(
            extra.get("enable_glossy_reflection", False)),
        enable_environment_mapping=bool(
            extra.get("enable_environment_mapping", False)),
        enable_bilinear_texture_filtering=bool(
            extra.get("enable_bilinear_texture_filtering", False)),
        enable_mipmap_texture_filtering=bool(
            extra.get("enable_mipmap_texture_filtering", False)),
    )

    for cam in table.get("cameras", []) or []:  # config.cpp:317-326
        config.cameras.append(CameraConfig(
            field_of_view=float(cam.get("field_of_view", 50.0)),
            distance_from_look_at=float(
                cam.get("distance_from_look_at", 3.0)),
            look_at=_vec3(cam.get("look_at")),
            rotation=_vec3(cam.get("rotation"), (20.0, 20.0, 0.0)),
        ))

    lights = table.get("lights")
    if lights:  # config.cpp:328-371
        for light in lights:
            ltype = str(light.get("type", "none"))
            if ltype == "point":
                config.lights.append(PointLight(
                    position=_vec3(light.get("position")),
                    color=_vec3(light.get("color"))))
            elif ltype == "segment":
                eps = light.get("endpoints", [])
                cols = light.get("colors", [])
                config.lights.append(SegmentLight(
                    endpoint0=_vec3(eps[0] if len(eps) > 0 else None),
                    endpoint1=_vec3(eps[1] if len(eps) > 1 else None),
                    color0=_vec3(cols[0] if len(cols) > 0 else None),
                    color1=_vec3(cols[1] if len(cols) > 1 else None)))
            elif ltype == "parallelogram":
                edges = light.get("edges", [])
                cols = light.get("colors", [])
                config.lights.append(ParallelogramLight(
                    v0=_vec3(light.get("corner")),
                    edge01=_vec3(edges[0] if len(edges) > 0 else None),
                    edge02=_vec3(edges[1] if len(edges) > 1 else None),
                    color0=_vec3(cols[0] if len(cols) > 0 else None),
                    color1=_vec3(cols[1] if len(cols) > 1 else None),
                    color2=_vec3(cols[2] if len(cols) > 2 else None),
                    color3=_vec3(cols[3] if len(cols) > 3 else None)))
            else:
                print(f"Unknown light type: {ltype} -- Skip", file=sys.stderr)
    else:
        print("WARN: No lights found in config file.", file=sys.stderr)

    return config
