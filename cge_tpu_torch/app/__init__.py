"""The interactive app (counterpart of cge_tpu/app): the reference's GUI
mode (src/main.cpp:45-477; view switch, scene picker, feature toggles and
sliders, a light editor with a translation gizmo, debug rays, BVH
overlays, render to file) as a local web app. A standard-library HTTP
server (app/server.py) holds an AppState (app/state.py) and renders frames
on demand, the raster preview or the ray trace; the page (ui.html) is the
panel and the trackball.

Run: python -m cge_tpu_torch.app [--port 8642] [--scene cornell_box]
"""

from cge_tpu_torch.app.state import AppState

__all__ = ["AppState"]
