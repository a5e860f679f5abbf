"""The interactive app's state and frames (counterpart of
cge_tpu/app/state.py:36-522).

The testable core behind the web UI: each panel interaction of the
reference's ImGui loop (src/main.cpp:120-477) is a method here. Ray-traced
frames run the port's renderer on the app's device (the accel's kernels,
or K3, on the card); the raster view is raster.render_preview with the
debug overlays of viz.debug drawn in on the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.ops.bvh import build_reference_bvh
from cge_tpu_torch.raster.preview import render_preview
from cge_tpu_torch.render.renderer import prepare_render, render_image
from cge_tpu_torch.scene.image_io import write_bmp
from cge_tpu_torch.scene.mesh_io import load_mesh
from cge_tpu_torch.scene.scene import (DEFAULT_DATA_DIR, ParallelogramLight,
                                       PointLight, SceneType, SegmentLight,
                                       build_scene_arrays,
                                       deserialize_scene_type,
                                       prebuilt_scene_parts, replace_lights,
                                       resolve_device, serialize_scene_type)
from cge_tpu_torch.types import Features, RenderParams
from cge_tpu_torch.viz.debug import (aabb_segments, debug_dof_rays,
                                     debug_ray_samples, debug_trace,
                                     draw_segments, project_points,
                                     traversal_debug)

_FEATURE_FIELDS = [f.name for f in dataclasses.fields(Features)]
_PARAM_FIELDS = [f.name for f in dataclasses.fields(RenderParams)]

_L3 = lambda v: tuple(float(x) for x in v)  # noqa: E731


class AppState:
    """The interactive app's mutable state (scene, view, lights, overlays)."""

    def __init__(self, scene: str = "cornell_box", width: int = 256,
                 height: int = 256, output_dir: str | None = None,
                 data_dir: str = DEFAULT_DATA_DIR, device=None):
        """scene: a scene name or an .obj path; output_dir: where
        render_to_file writes (cge_out in the temporary directory by
        default); data_dir: the prebuilt scenes' data directory; device:
        where scenes live and frames render (the card by default)."""
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.width = width
        self.height = height
        self.view_mode = "raster"          # ViewMode (main.cpp:33-37)
        self.features = Features()
        self.params = RenderParams()
        self.camera = Camera()
        self.output_dir = (os.path.join(tempfile.gettempdir(), "cge_out")
                           if output_dir is None else output_dir)
        self.selected_light: int = -1
        self.selected_handle: int = 0      # gizmo endpoint/vertex combo
        self.debug_levels: list = []        # stored debug rays (optDebugRay)
        self.debug_pixel: Optional[tuple] = None
        self.bvh_show_level: int = -1       # debugBVHLevel slider
        self.bvh_show_leaf: int = -1        # debugBVHLeaf slider
        self.bvh_sah: bool = False
        self.bvh_traversal: bool = False    # debugBVHTraversal checkbox
        self.bvh_recursion_level: int = 0   # bvhRecursionLevel slider
        self.sah_splits: bool = False       # drawSAHSplits checkbox
        self.sah_split_level: int = 0       # sahDebugLevel slider
        self.sah_split_axis: int = 0        # sahDebugAxis slider
        self._bvh_cache = {}
        self.set_scene(scene)

    # ------------------------------------------------------------------ scene

    def set_scene(self, name_or_path: str):
        """Scene picker (main.cpp:126-147) or OBJ file load."""
        t = deserialize_scene_type(name_or_path)
        if t is not None:
            meshes, spheres, lights = prebuilt_scene_parts(t, self.data_dir)
            self.scene_name = serialize_scene_type(t)
        elif os.path.exists(name_or_path):
            meshes = load_mesh(name_or_path)
            spheres = []
            lights = [PointLight((-1, 1, -1), (1, 1, 1))]
            self.scene_name = name_or_path
        else:
            raise ValueError(f"unknown scene: {name_or_path}")
        self.lights = list(lights)
        base = build_scene_arrays(meshes, spheres, (), device=self.device)
        self.scene = replace_lights(base, self.lights)
        self.selected_light = 0 if self.lights else -1
        self.selected_handle = 0
        self.debug_levels = []
        self.debug_pixel = None
        self._bvh_cache = {}

    # --------------------------------------------------------------- features

    def update_features(self, changes: dict):
        kw = {k: bool(v) for k, v in changes.items() if k in _FEATURE_FIELDS}
        self.features = self.features.replace(**kw)

    def update_params(self, changes: dict):
        kw = {}
        for k, v in changes.items():
            if k not in _PARAM_FIELDS:
                continue
            cur = getattr(self.params, k)
            kw[k] = type(cur)(v) if cur is not None else v
        self.params = self.params.replace(**kw)

    def set_view(self, mode: Optional[str] = None, width: Optional[int] = None,
                 height: Optional[int] = None):
        if mode in ("raster", "raytrace"):
            self.view_mode = mode
        if width:
            self.width = int(width)
        if height:
            self.height = int(height)

    # ----------------------------------------------------------------- camera

    def camera_op(self, op: str, dx: float = 0.0, dy: float = 0.0):
        """Trackball mouse handlers (trackball.cpp:136-164)."""
        if op == "orbit":
            self.camera = self.camera.orbit(dx, dy)
        elif op == "pan":
            self.camera = self.camera.pan(dx, dy)
        elif op == "zoom":
            self.camera = self.camera.zoom(dy)
        elif op == "reset":
            self.camera = Camera()
        else:
            raise ValueError(f"unknown camera op: {op}")

    # ----------------------------------------------------------------- lights

    def _sync_lights(self):
        self.scene = replace_lights(self.scene, self.lights)

    def add_light(self, kind: str):
        """The Add buttons with the reference's exact defaults
        (main.cpp:348-368: segment red->blue 0->(1,1,1), parallelogram
        red/green/blue/white unit square)."""
        if kind == "point":
            self.lights.append(PointLight((0, 0, 0), (1, 1, 1)))
        elif kind == "segment":
            self.lights.append(SegmentLight((0, 0, 0), (1, 1, 1),
                                            (1, 0, 0), (0, 0, 1)))
        elif kind == "parallelogram":
            self.lights.append(ParallelogramLight(
                (0, 0, 0), (1, 0, 0), (0, 1, 0),
                (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)))
        else:
            raise ValueError(f"unknown light kind: {kind}")
        self.selected_light = len(self.lights) - 1
        self.selected_handle = 0
        self._sync_lights()

    def remove_light(self, index: int):
        """main.cpp:354-360."""
        if 0 <= index < len(self.lights):
            self.lights.pop(index)
            self.selected_light = min(self.selected_light,
                                      len(self.lights) - 1)
            self.selected_handle = 0
            self._sync_lights()

    def update_light(self, index: int, fields: dict):
        """Gizmo translation / color edits (main.cpp:295-338)."""
        light = self.lights[index]
        kw = {}
        for k, v in fields.items():
            if hasattr(light, k):
                kw[k] = _L3(v)
        self.lights[index] = dataclasses.replace(light, **kw)
        self._sync_lights()

    # ------------------------------------------------------------------ gizmo

    def _gizmo_handles(self, light):
        """Draggable translation handles per light kind, mirroring the
        reference's gizmo target choices (main.cpp:295-325): point ->
        position; segment -> endpoint 0/1; parallelogram -> v0, v0+edge01,
        v0+edge02 (edges recomputed from the moved vertex)."""
        if isinstance(light, PointLight):
            return [("position", np.asarray(light.position, np.float32))]
        if isinstance(light, SegmentLight):
            return [("endpoint0", np.asarray(light.endpoint0, np.float32)),
                    ("endpoint1", np.asarray(light.endpoint1, np.float32))]
        v0 = np.asarray(light.v0, np.float32)
        return [("v0", v0),
                ("vertex1", v0 + np.asarray(light.edge01, np.float32)),
                ("vertex2", v0 + np.asarray(light.edge02, np.float32))]

    def _set_gizmo_handle(self, index: int, handle: int, pos: np.ndarray):
        """Write a moved handle back (parallelogram vertex moves update the
        edge, main.cpp:330-336; v0 moves translate the whole light the way
        ImGuizmo's model matrix does for the anchor vertex)."""
        light = self.lights[index]
        pos = _L3(pos)
        if isinstance(light, (PointLight, SegmentLight)):
            name = self._gizmo_handles(light)[handle][0]
            self.lights[index] = dataclasses.replace(light, **{name: pos})
        else:
            if handle == 0:
                self.lights[index] = dataclasses.replace(light, v0=pos)
            elif handle == 1:
                edge = tuple(np.asarray(pos) - np.asarray(light.v0))
                self.lights[index] = dataclasses.replace(light,
                                                         edge01=_L3(edge))
            else:
                edge = tuple(np.asarray(pos) - np.asarray(light.v0))
                self.lights[index] = dataclasses.replace(light,
                                                         edge02=_L3(edge))
        self._sync_lights()

    def select_handle(self, handle: int):
        """The endpoint/vertex combo next to the gizmo (main.cpp:301-330)."""
        self.selected_handle = int(handle)

    def _gizmo_axes(self):
        """Screen geometry of the translation gizmo for the selected light:
        anchor + three world-axis arms, sized to a constant screen fraction
        like ImGuizmo's SetGizmoSizeClipSpace (imguizmo.cpp:10)."""
        if not (0 <= self.selected_light < len(self.lights)):
            return None
        light = self.lights[self.selected_light]
        handles = self._gizmo_handles(light)
        h = min(self.selected_handle, len(handles) - 1)
        anchor = handles[h][1]
        cam_pos = self.camera.position("cpu").numpy()
        depth = float(np.linalg.norm(anchor - cam_pos))
        arm = 0.15 * depth * self.camera.half_screen_h
        ends = anchor[None, :] + arm * np.eye(3, dtype=np.float32)
        pts = np.concatenate([anchor[None, :], ends])
        px, in_front = project_points(self.camera, pts,
                                      self.width, self.height)
        return dict(anchor=anchor, arm=arm, ends=ends, px=px,
                    in_front=in_front, handle=h,
                    handle_names=[n for n, _ in handles])

    def gizmo_drag(self, axis: int, dx: float, dy: float):
        """Translate the selected handle along world axis 0/1/2 from a
        mouse drag of (dx, dy) *pixels*: the drag is projected onto the
        axis's screen direction — ImGuizmo::Manipulate TRANSLATE semantics
        for a single arm (imguizmo.cpp:16-18)."""
        g = self._gizmo_axes()
        if g is None:
            return
        axis = int(axis)
        sdir = g["px"][1 + axis] - g["px"][0]       # axis arm in pixels
        n2 = float(sdir @ sdir)
        if n2 < 1e-12:                               # axis points at camera
            return
        s = float(np.array([dx, dy], np.float32) @ sdir) / n2 * g["arm"]
        delta = np.zeros(3, np.float32)
        delta[axis] = s
        self._set_gizmo_handle(self.selected_light, g["handle"],
                               g["anchor"] + delta)

    def light_list(self):
        out = []
        for l in self.lights:
            d = {"kind": type(l).__name__}
            d.update({k: list(v) for k, v in dataclasses.asdict(l).items()})
            out.append(d)
        return out

    # -------------------------------------------------------------- debug ray

    def shoot_debug_ray(self, nx: float, ny: float):
        """The R-key debug ray (main.cpp:87-104): nx, ny in [-1, 1].

        Feature-sensitive like the reference: with MSAA on the full jittered
        sample fan is shot (main.cpp:95-98), with DoF the disk-sampled ray
        set (main.cpp:99-100), else the single pinhole ray — all replayed
        through every bounce level incl. transparency continuations."""
        if self.features.enable_multiple_rays_per_pixel:
            o, d = debug_ray_samples(nx, ny, self.camera, self.params,
                                     self.width, self.height,
                                     device=self.device)
        elif self.features.enable_depth_of_field:
            o, d = debug_dof_rays(nx, ny, self.camera, self.params,
                                  device=self.device)
        else:
            o, d = self.camera.generate_rays(torch.tensor(
                [[nx, ny]], dtype=torch.float32, device=self.device))
        self.debug_levels = debug_trace(self.scene, o, d, self.features,
                                        self.params)
        self.debug_pixel = (float(nx), float(ny))

    def clear_debug_ray(self):
        self.debug_levels = []
        self.debug_pixel = None

    # -------------------------------------------------------------------- bvh

    def _bvh(self):
        key = self.bvh_sah
        if key not in self._bvh_cache:
            self._bvh_cache[key] = build_reference_bvh(
                self.scene, sah_binning=self.bvh_sah)
        return self._bvh_cache[key]

    def _sah_bvh(self):
        """SAH build with recorded candidate cut planes (debugDrawSAHSplits
        needs sahCutsPerLevel, which only an SAH build fills)."""
        if "sah_cuts" not in self._bvh_cache:
            self._bvh_cache["sah_cuts"] = build_reference_bvh(
                self.scene, sah_binning=True, record_sah_cuts=True)
        return self._bvh_cache["sah_cuts"]

    def set_bvh_debug(self, level: Optional[int] = None,
                      leaf: Optional[int] = None,
                      sah: Optional[bool] = None,
                      traversal: Optional[bool] = None,
                      recursion_level: Optional[int] = None,
                      sah_splits: Optional[bool] = None,
                      sah_split_level: Optional[int] = None,
                      sah_split_axis: Optional[int] = None):
        """The BVH debug sliders (main.cpp:438-463, 250-265)."""
        if level is not None:
            self.bvh_show_level = int(level)
        if leaf is not None:
            self.bvh_show_leaf = int(leaf)
        if sah is not None:
            self.bvh_sah = bool(sah)
        if traversal is not None:
            self.bvh_traversal = bool(traversal)
        if recursion_level is not None:
            self.bvh_recursion_level = int(recursion_level)
        if sah_splits is not None:
            self.sah_splits = bool(sah_splits)
        if sah_split_level is not None:
            self.sah_split_level = int(sah_split_level)
        if sah_split_axis is not None:
            self.sah_split_axis = int(sah_split_axis) % 3

    # ------------------------------------------------------------------ frame

    def _render_ctx(self):
        """Per-scene prepared render state (accel + attribute tables),
        rebuilt when the scene object, features or params change — the
        interactive analogue of the reference's once-per-scene BVH build
        (main.cpp:219-221). Light edits replace the scene object and
        conservatively rebuild (tables don't depend on lights, but the
        rebuild is cheap next to a frame)."""
        # identity via a STRONG reference, not id(): a freed scene object's
        # address can be reused by a new scene, matching a stale id key and
        # rendering with the previous scene's accel tables (ADVICE r4)
        key = (self.features, self.params)
        if getattr(self, "_ctx_scene", None) is not self.scene \
                or getattr(self, "_ctx_key", None) != key:
            self._ctx = prepare_render(self.scene, self.features,
                                       self.params)
            self._ctx_scene = self.scene
            self._ctx_key = key
        return self._ctx

    def frame(self) -> np.ndarray:
        """Compose the current frame [H, W, 3] u8 (the per-frame branch,
        main.cpp:379-473): raster preview with debug overlays, or the ray
        trace."""
        if self.view_mode == "raytrace":
            img = render_image(self.scene, self.camera, self.features,
                               self.params, self.width, self.height,
                               ctx=self._render_ctx()).cpu().numpy()
            img = np.nan_to_num(img)
            # the interactive raytrace view stamps screen pixel (0, 0) white
            # after each trace (main.cpp:468); setPixel's y-flip
            # (screen.cpp:45) puts screen (0, 0) at the image's bottom-left
            img = img.copy()
            img[-1, 0] = 1.0
        else:
            img = render_preview(self.scene, self.camera, self.width,
                                 self.height).cpu().numpy()
            img = self._overlays(img)
        return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)

    def _overlays(self, img):
        # debug rays (replayed every raster frame, main.cpp:391-403)
        for lvl in self.debug_levels:
            a = lvl.origin
            b = lvl.origin + np.minimum(lvl.t, 100.0)[:, None] * lvl.dir
            for i in range(a.shape[0]):
                img = draw_segments(img, self.camera, a[i:i + 1],
                                    b[i:i + 1],
                                    color=np.clip(lvl.color[i], 0, 1))
        # BVH level / leaf wireframes (main.cpp:438-463)
        if self.bvh_show_level >= 0:
            bvh = self._bvh()
            lo, hi = bvh.debug_level_boxes(self.bvh_show_level)
            if len(lo):
                a, b = aabb_segments(lo, hi)
                img = draw_segments(img, self.camera, a, b,
                                    color=(0.0, 1.0, 0.0))
        if self.bvh_show_leaf >= 0:
            bvh = self._bvh()
            leaf = bvh.debug_leaf(self.bvh_show_leaf)
            if leaf is not None:
                lo, hi, _, _ = leaf
                a, b = aabb_segments(lo, hi)
                img = draw_segments(img, self.camera, a, b,
                                    color=(1.0, 1.0, 0.0))
        # traversal-visited nodes of the stored debug rays
        # (bounding_volume_hierarchy.cpp:338-360, enabled via
        # debugBVHTraversal + setDebugRecursionLevel, main.cpp:458-460).
        # The reference gates every draw on m_recursionLevel(=0, never
        # updated) == RECURSION_LEVEL(slider), so its slider only draws at
        # 0 — mirrored here; slider > 0 additionally filters the visited
        # set by node depth (a documented extension that makes the slider
        # meaningful).
        if self.bvh_traversal and self.debug_levels \
                and self.features.enable_accel_structure:
            bvh = self._bvh()
            lvl = self.bvh_recursion_level
            for rays in self.debug_levels:
                for i in range(rays.origin.shape[0]):
                    td = traversal_debug(bvh, self.scene, rays.origin[i],
                                         rays.dir[i])
                    vsel = (slice(None) if lvl == 0
                            else td.visited_depth == lvl)
                    dsel = (slice(None) if lvl == 0
                            else td.dead_depth == lvl)
                    if td.visited_lo[vsel].shape[0]:
                        a, b = aabb_segments(td.visited_lo[vsel],
                                             td.visited_hi[vsel])
                        img = draw_segments(img, self.camera, a, b,
                                            color=(0.9, 0.9, 0.9))
                    if td.dead_lo[dsel].shape[0]:
                        a, b = aabb_segments(td.dead_lo[dsel],
                                             td.dead_hi[dsel])
                        img = draw_segments(img, self.camera, a, b,
                                            color=(0.9, 0.0, 0.0))
                    if td.tri is not None and lvl == 0:
                        # debugDrawTriangle on the winning primitive
                        # (cpp:376-378)
                        tri = td.tri
                        img = draw_segments(
                            img, self.camera, tri,
                            tri[[1, 2, 0]], color=(0.2, 1.0, 0.2))
        # SAH candidate split planes (debugDrawSAHSplits, cpp:230-237):
        # chosen plane green, the rest red
        if self.sah_splits:
            lo, hi, chosen = self._sah_bvh().debug_sah_splits(
                self.sah_split_level, self.sah_split_axis)
            for sel, color in ((~chosen, (1.0, 0.0, 0.0)),
                               (chosen, (0.0, 1.0, 0.0))):
                if np.count_nonzero(sel):
                    a, b = aabb_segments(lo[sel], hi[sel])
                    img = draw_segments(img, self.camera, a, b, color=color)
        # translation gizmo on the selected light (main.cpp:295-325):
        # RGB = world x/y/z arms, ImGuizmo's axis color convention
        g = self._gizmo_axes()
        if g is not None:
            for axis, color in enumerate(((1.0, 0.2, 0.2), (0.2, 1.0, 0.2),
                                          (0.3, 0.45, 1.0))):
                img = draw_segments(img, self.camera, g["anchor"],
                                    g["ends"][axis], color=color)
        return img

    # --------------------------------------------------------- render to file

    def render_to_file(self, width: int = 800, height: int = 800):
        """The "Render to file" button (main.cpp:222-240): full ray trace,
        timestamped BMP, wall-time report."""
        os.makedirs(self.output_dir, exist_ok=True)
        t0 = time.perf_counter()
        img = np.nan_to_num(render_image(
            self.scene, self.camera, self.features, self.params,
            width, height, ctx=self._render_ctx()).cpu().numpy())
        ms = (time.perf_counter() - t0) * 1e3
        stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
        name = os.path.basename(str(self.scene_name)).replace(".obj", "")
        path = os.path.join(self.output_dir, f"render_{name}_{stamp}.bmp")
        write_bmp(path, img)
        return path, ms

    # ------------------------------------------------------------------ state

    def _gizmo_json(self):
        g = self._gizmo_axes()
        if g is None:
            return None
        return {"anchor_px": [round(float(v), 1) for v in g["px"][0]],
                "axes_px": [[round(float(v), 1) for v in p]
                            for p in g["px"][1:]],
                "in_front": [bool(b) for b in g["in_front"]],
                "handle": g["handle"],
                "handle_names": g["handle_names"]}

    def state_json(self) -> dict:
        cam = self.camera
        return {
            "scene": self.scene_name,
            "scenes": [serialize_scene_type(t) for t in SceneType
                       if t != SceneType.Dragon],
            "view_mode": self.view_mode,
            "width": self.width,
            "height": self.height,
            "features": dataclasses.asdict(self.features),
            "params": {k: v for k, v in
                       dataclasses.asdict(self.params).items()
                       if not k.startswith(("ray_tile", "trace_chunk",
                                            "tri_tile", "prims"))},
            "camera": {"fovy_deg": float(np.degrees(cam.fovy)),
                       "distance": float(cam.distance),
                       "look_at": list(cam.look_at),
                       "rotation_deg":
                           [float(np.degrees(r)) for r in cam.rotation]},
            "lights": self.light_list(),
            "selected_light": self.selected_light,
            "gizmo": self._gizmo_json(),
            "bvh": {"show_level": self.bvh_show_level,
                    "show_leaf": self.bvh_show_leaf,
                    "sah": self.bvh_sah,
                    "traversal": self.bvh_traversal,
                    "recursion_level": self.bvh_recursion_level,
                    "sah_splits": self.sah_splits,
                    "sah_split_level": self.sah_split_level,
                    "sah_split_axis": self.sah_split_axis,
                    "num_levels": self._bvh().num_levels,
                    "num_leaves": self._bvh().num_leaves},
            "debug_pixel": self.debug_pixel,
            "num_tris": int(self.scene.tri_mask.sum()),
        }
