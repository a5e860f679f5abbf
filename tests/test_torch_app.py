"""The port's interactive app against the JAX package's, on the 41x32
dragon stand-in OBJ (tools/make_large_asset.py) at 32x32.

Both AppStates go through the same interactions: frames (the raster
preview with its overlays, and the ray trace with the accel on, JAX's
cluster path in interpret mode, and off), camera operations, feature and
parameter toggles, the light editor and the gizmo's handles, debug rays,
the BVH level, leaf, traversal and SAH overlays, render_to_file, and the
HTTP routes served on port 0 (the same status codes and JSON). Frames are
compared as u8: >= 99.5% of pixels within 1 of 255; state JSON equal, the
gizmo's pixel positions within 0.2 px.
"""

import http.client
import json
import os
import re

import numpy as np
import pytest
import torch

from cge_tpu.app import server as jserver
from cge_tpu.app.state import AppState as JAppState
from cge_tpu.ops import intersect as jint
from cge_tpu.scene.image_io import read_bmp as jread_bmp
from cge_tpu_torch.app import __main__ as app_main
from cge_tpu_torch.app import server as pserver
from cge_tpu_torch.app.state import AppState as PAppState
from cge_tpu_torch.scene.image_io import decode_png, read_bmp
from tools.make_large_asset import write_obj

torch.set_num_threads(2)
SIZE = 32


@pytest.fixture(scope="module")
def obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("app") / "dragon.obj")
    write_obj(path, 41, 32)
    return path


@pytest.fixture(scope="module")
def apps(obj, tmp_path_factory):
    out = tmp_path_factory.mktemp("app_out")
    mp = pytest.MonkeyPatch()
    mp.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    j = JAppState(scene=obj, width=SIZE, height=SIZE,
                  output_dir=str(out / "jax"))
    p = PAppState(scene=obj, width=SIZE, height=SIZE,
                  output_dir=str(out / "port"), device="cpu")
    yield j, p
    mp.undo()


def _close_frames(a, b):
    assert a.shape == b.shape == (SIZE, SIZE, 3) and b.dtype == np.uint8
    close = (np.abs(a.astype(int) - b.astype(int)) <= 1).all(-1).mean()
    assert close >= 0.995, close


def _strip_gizmo(s):
    s = dict(s)
    g = s.pop("gizmo")
    s["camera"] = dict(s["camera"])
    s["camera"]["look_at"] = np.round(s["camera"]["look_at"], 6).tolist()
    return s, g


def _same_state(j, p):
    """Equal state JSON; the camera's look_at (moved by pans through the
    trackball's rotation) to 1e-6, the gizmo's pixels to 0.2."""
    js, jg = _strip_gizmo(j.state_json())
    ps, pg = _strip_gizmo(p.state_json())
    assert ps == js
    assert (pg is None) == (jg is None)
    if pg is not None:
        for k in ("handle", "handle_names", "in_front"):
            assert pg[k] == jg[k]
        np.testing.assert_allclose(pg["anchor_px"], jg["anchor_px"],
                                   atol=0.2)
        np.testing.assert_allclose(pg["axes_px"], jg["axes_px"], atol=0.2)


def _both(apps, method, *args, **kw):
    return [getattr(a, method)(*args, **kw) for a in apps]


def test_initial_state_and_raster_frame(apps):
    _same_state(*apps)
    j, p = apps
    assert p.state_json()["num_tris"] == 2560
    _close_frames(*_both(apps, "frame"))


@pytest.mark.parametrize("accel", [True, False])
def test_raytrace_frames(apps, accel):
    _both(apps, "set_view", mode="raytrace")
    _both(apps, "update_features", {
        "enable_shading": True, "enable_hard_shadow": True,
        "enable_normal_interp": True, "enable_accel_structure": accel})
    _both(apps, "update_params", {"ray_depth": 2, "nope": 3})
    jf, pf = _both(apps, "frame")
    _close_frames(jf, pf)
    assert (pf[-1, 0] == 255).all() and pf.max() > 20   # the white stamp
    _same_state(*apps)
    _both(apps, "set_view", mode="raster")


def test_camera_ops(apps):
    before = apps[1].frame()
    for op, dx, dy in (("orbit", 40.0, 10.0), ("pan", 5.0, -3.0),
                       ("zoom", 0.0, 1.0)):
        _both(apps, "camera_op", op, dx, dy)
        _same_state(*apps)
    jf, pf = _both(apps, "frame")
    _close_frames(jf, pf)
    assert (pf != before).any()
    _both(apps, "camera_op", "reset")
    _same_state(*apps)
    for a in apps:
        with pytest.raises(ValueError):
            a.camera_op("spin")


def test_light_editor_and_gizmo(apps):
    n0 = len(apps[1].lights)
    for kind in ("segment", "parallelogram", "point"):
        _both(apps, "add_light", kind)
        _same_state(*apps)
    _both(apps, "update_light", n0, {"color0": (0.0, 1.0, 0.0),
                                     "bogus": (1, 2, 3)})
    assert apps[1].light_list()[n0]["color0"] == [0.0, 1.0, 0.0]
    for light, handle, axis in ((n0, 1, 1), (n0 + 1, 1, 2), (n0 + 1, 2, 0),
                                (0, 0, 0)):
        for a in apps:
            a.selected_light = light
        _both(apps, "select_handle", handle)
        g = apps[1].state_json()["gizmo"]
        sdir = np.array(g["axes_px"][axis]) - np.array(g["anchor_px"])
        _both(apps, "gizmo_drag", axis, float(sdir[0]), float(sdir[1]))
        jl, pl = (a.light_list() for a in apps)
        for x, y in zip(jl, pl):
            assert x["kind"] == y["kind"]
            for k in x:
                if k != "kind":
                    np.testing.assert_allclose(y[k], x[k], atol=1e-5)
    par = apps[1].light_list()[n0 + 1]
    assert par["edge02"] != [0.0, 1.0, 0.0] and par["v0"] == [0.0, 0.0, 0.0]
    _close_frames(*_both(apps, "frame"))
    for a in apps:
        a.selected_light = -1
    _close_frames(*_both(apps, "frame"))
    for _ in range(3):
        _both(apps, "remove_light", n0)
    _both(apps, "remove_light", 99)
    for a in apps:
        a.selected_light = 0
        with pytest.raises(ValueError):
            a.add_light("spot")
    _same_state(*apps)


def test_debug_ray_and_bvh_overlays(apps):
    _both(apps, "update_features", {"enable_shading": True,
                                    "enable_hard_shadow": True,
                                    "enable_recursive": True,
                                    "enable_accel_structure": True})
    base = apps[1].frame()
    for nx, ny in ((-0.2, -0.2), (0.05, -0.1), (0.0, 0.0), (-0.1, 0.1)):
        _both(apps, "shoot_debug_ray", nx, ny)  # a pixel with a mirror hit
        if len(apps[1].debug_levels) >= 2:
            break
    jl, pl = (a.debug_levels for a in apps)
    assert [len(l.hit) for l in pl] == [len(l.hit) for l in jl]
    assert len(pl) >= 2 and pl[0].hit.any()
    for settings in (dict(level=2), dict(level=-1, leaf=3),
                     dict(leaf=-1, sah=True, level=1),
                     dict(level=-1, sah=False, traversal=True,
                          recursion_level=0),
                     dict(recursion_level=2),
                     dict(traversal=False, sah_splits=True,
                          sah_split_level=1, sah_split_axis=4)):
        _both(apps, "set_bvh_debug", **settings)
        _same_state(*apps)
        jf, pf = _both(apps, "frame")
        _close_frames(jf, pf)
        assert (pf != base).any()
    _both(apps, "set_bvh_debug", sah_splits=False)
    _both(apps, "clear_debug_ray")
    _close_frames(*_both(apps, "frame"))


def test_debug_ray_sample_sets(apps):
    """With MSAA on the debug shot is the jittered fan, with DoF the disk
    samples (main.cpp:95-100): viz.debug's sets (held to JAX's in
    test_torch_viz.py) replayed through every level."""
    from cge_tpu_torch.viz import debug

    p = apps[1]
    for flag, fn, n in (
            ("enable_multiple_rays_per_pixel", debug.debug_ray_samples, 9),
            ("enable_depth_of_field", debug.debug_dof_rays, 5)):
        p.update_features({flag: True})
        p.shoot_debug_ray(0.0, 0.0)
        args = ((p.width, p.height) if n == 9 else ())
        o, d = fn(0.0, 0.0, p.camera, p.params, *args, device="cpu")
        lvl = p.debug_levels[0]
        assert lvl.origin.shape == (n, 3)
        np.testing.assert_array_equal(lvl.dir, d.numpy())
        np.testing.assert_array_equal(lvl.origin, o.numpy())
        p.update_features({flag: False})
        p.clear_debug_ray()
    assert p.debug_pixel is None


def test_render_to_file(apps):
    (jp, jms), (pp, pms) = _both(apps, "render_to_file", 24, 16)
    name = re.compile(r"^render_dragon_\d{4}-\d\d-\d\d-\d\d:\d\d:\d\d\.bmp$")
    assert name.match(os.path.basename(pp)) and pms > 0
    a = np.round(jread_bmp(jp) * 255).astype(int)
    b = np.round(read_bmp(pp) * 255).astype(int)
    assert b.shape == (16, 24, 3)
    assert (np.abs(a - b) <= 1).all(-1).mean() >= 0.995


def test_scene_switch(apps, obj):
    _both(apps, "set_scene", "spheres")
    _same_state(*apps)
    assert apps[1].state_json()["scene"] == "spheres"
    _close_frames(*_both(apps, "frame"))
    for a in apps:
        with pytest.raises(ValueError):
            a.set_scene("nope")
    _both(apps, "set_scene", obj)
    _same_state(*apps)


def test_prebuilt_scenes_need_a_data_dir(capsys):
    """The port has no default data directory: a prebuilt mesh scene
    without data_dir raises, naming it, and `python -m cge_tpu_torch.app`
    exits 2 with that message before it serves; Spheres needs no data."""
    with pytest.raises(FileNotFoundError, match="data_dir"):
        PAppState(scene="cornell_box", width=8, height=8, device="cpu")
    with pytest.raises(SystemExit) as e:
        app_main.main(["--scene", "cornell_box", "--device", "cpu"])
    assert e.value.code == 2 and "data_dir" in capsys.readouterr().err
    state = PAppState(scene="spheres", width=8, height=8, device="cpu")
    assert state.frame().shape == (8, 8, 3)


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), data


ROUTES = [
    ("GET", "/api/state", None),
    ("POST", "/api/camera", {"op": "orbit", "dx": 10, "dy": 5}),
    ("POST", "/api/features", {"enable_shading": True,
                               "enable_hard_shadow": True}),
    ("POST", "/api/params", {"ray_depth": 1}),
    ("POST", "/api/view", {"width": 24, "height": 24}),
    ("POST", "/api/light", {"op": "add", "kind": "segment"}),
    ("POST", "/api/light", {"op": "select", "index": 1}),
    ("POST", "/api/light", {"op": "select_handle", "handle": 1}),
    ("POST", "/api/gizmo", {"axis": 1, "dx": 3.0, "dy": -4.0}),
    ("POST", "/api/light", {"op": "update", "index": 1,
                            "fields": {"color1": [0, 1, 0]}}),
    ("POST", "/api/light", {"op": "remove", "index": 1}),
    ("POST", "/api/debug_ray", {"x": 0.0, "y": 0.0}),
    ("POST", "/api/bvh", {"level": 1, "traversal": True}),
    ("POST", "/api/debug_ray", {"clear": True}),
    ("POST", "/api/scene", {"scene": "nope"}),
    ("POST", "/api/camera", {"op": "spin"}),
    ("POST", "/api/nothing", {}),
    ("GET", "/api/nonexistent", None),
    ("GET", "/api/output?path=/etc/passwd", None),
]


def test_http_routes_match_jax(obj, tmp_path, monkeypatch):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    states = [JAppState(scene=obj, width=SIZE, height=SIZE,
                        output_dir=str(tmp_path / "jax")),
              PAppState(scene=obj, width=SIZE, height=SIZE,
                        output_dir=str(tmp_path / "port"), device="cpu")]
    servers = [jserver.serve(states[0], port=0, background=True),
               pserver.serve(states[1], port=0, background=True)]
    try:
        ports = [s.server_address[1] for s in servers]
        st, ctype, page = _req(ports[1], "GET", "/")
        assert st == 200 and "text/html" in ctype
        assert b"cge_tpu_torch" in page
        for method, path, body in ROUTES:
            (js, jt, jd), (ps, pt, pd) = (_req(p, method, path, body)
                                          for p in ports)
            assert (ps, pt) == (js, jt), path
            jo, po = json.loads(jd), json.loads(pd)
            if "state" in jo:
                jg, pg = jo["state"].pop("gizmo"), po["state"].pop("gizmo")
                assert (jg is None) == (pg is None)
            if "error" in jo:
                assert "error" in po
            else:
                assert po == jo, path
        frames = []
        for port in ports:
            st, ctype, data = _req(port, "GET", "/api/frame")
            assert st == 200 and ctype == "image/png"
            frames.append(decode_png(data))
        assert frames[1].shape == (24, 24, 3)
        assert (np.abs(frames[0].astype(int) - frames[1].astype(int))
                <= 1).all(-1).mean() >= 0.995
        np.testing.assert_array_equal(frames[1], states[1].frame())
        st, _, data = _req(ports[1], "POST", "/api/render_file",
                           {"width": 8, "height": 8})
        out = json.loads(data)
        assert st == 200 and out["ok"] and out["path"].endswith(".bmp")
        st, ctype, data = _req(ports[1], "GET",
                               f"/api/output?path={out['path']}")
        assert st == 200 and ctype == "image/bmp" and data[:2] == b"BM"
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
