"""The interactive app's HTTP layer (counterpart of
cge_tpu/app/server.py:33-156).

A local web server on the standard library: GET / serves the panel page,
/api/* drives the AppState (app/state.py) with the JAX package's routes,
status codes and JSON. Frames are served as PNG (scene/image_io.py's
encoder). One thread serves every request, so requests run one at a time
against one AppState.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

from cge_tpu_torch.app.state import AppState
from cge_tpu_torch.scene.image_io import png_bytes

_UI_PATH = os.path.join(os.path.dirname(__file__), "ui.html")


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                with open(_UI_PATH, "rb") as f:
                    self._send(200, f.read(), "text/html")
            elif url.path == "/api/state":
                self._json(state.state_json())
            elif url.path == "/api/frame":
                try:
                    img = state.frame()
                    self._send(200, png_bytes(img), "image/png")
                except Exception as e:  # surface render errors to the UI
                    self._json({"error": str(e)}, 500)
            elif url.path == "/api/output":
                q = parse_qs(url.query)
                path = q.get("path", [""])[0]
                # resolve symlinks/.. before the containment check: a bare
                # startswith would pass '/out/../etc/passwd' and sibling
                # prefix dirs like '/out_x/'
                real = os.path.realpath(path)
                out_real = os.path.realpath(state.output_dir)
                contained = (os.path.commonpath([real, out_real]) == out_real
                             if os.path.isabs(real) else False)
                if contained and os.path.exists(real):
                    path = real
                    with open(path, "rb") as f:
                        self._send(200, f.read(), "image/bmp")
                else:
                    self._json({"error": "not found"}, 404)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            url = urlparse(self.path)
            try:
                route = url.path
                if route == "/api/scene":
                    state.set_scene(body["scene"])
                elif route == "/api/view":
                    state.set_view(body.get("mode"), body.get("width"),
                                   body.get("height"))
                elif route == "/api/features":
                    state.update_features(body)
                elif route == "/api/params":
                    state.update_params(body)
                elif route == "/api/camera":
                    state.camera_op(body["op"], body.get("dx", 0.0),
                                    body.get("dy", 0.0))
                elif route == "/api/light":
                    op = body["op"]
                    if op == "add":
                        state.add_light(body["kind"])
                    elif op == "remove":
                        state.remove_light(int(body["index"]))
                    elif op == "update":
                        state.update_light(int(body["index"]),
                                           body.get("fields", {}))
                    elif op == "select":
                        state.selected_light = int(body["index"])
                        state.selected_handle = 0
                    elif op == "select_handle":
                        state.select_handle(int(body["handle"]))
                elif route == "/api/gizmo":
                    state.gizmo_drag(int(body["axis"]),
                                     float(body.get("dx", 0.0)),
                                     float(body.get("dy", 0.0)))
                elif route == "/api/debug_ray":
                    if body.get("clear"):
                        state.clear_debug_ray()
                    else:
                        state.shoot_debug_ray(float(body["x"]),
                                              float(body["y"]))
                elif route == "/api/bvh":
                    state.set_bvh_debug(
                        body.get("level"), body.get("leaf"),
                        body.get("sah"), body.get("traversal"),
                        body.get("recursion_level"), body.get("sah_splits"),
                        body.get("sah_split_level"),
                        body.get("sah_split_axis"))
                elif route == "/api/render_file":
                    path, ms = state.render_to_file(
                        int(body.get("width", 800)),
                        int(body.get("height", 800)))
                    self._json({"ok": True, "path": path, "ms": ms})
                    return
                else:
                    self._json({"error": "not found"}, 404)
                    return
                self._json({"ok": True, "state": state.state_json()})
            except Exception as e:
                self._json({"error": str(e)}, 400)

    return Handler


def serve(state: AppState, port: int = 8642, background: bool = False):
    """Serve `state` on 127.0.0.1:port (port 0: any free port, read it from
    the returned server's server_address). background=True serves from a
    daemon thread and returns at once; else it serves until interrupted."""
    httpd = HTTPServer(("127.0.0.1", port), make_handler(state))
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    print(f"cge_tpu_torch interactive app: "
          f"http://127.0.0.1:{httpd.server_address[1]}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return httpd
