"""python -m cge_tpu_torch.app [--port N] [--scene NAME] [--size N]
[--output-dir DIR] [--data-dir DIR] [--device DEV]

The interactive counterpart of the reference's GUI branch (src/
main.cpp:55-477); the batch mode is cge_tpu_torch.cli. Frames render on
the card unless --device names another."""

from __future__ import annotations

import argparse

from cge_tpu_torch.app.server import serve
from cge_tpu_torch.app.state import AppState
from cge_tpu_torch.scene.scene import DEFAULT_DATA_DIR


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cge_tpu_torch.app",
                                 description="cge_tpu_torch interactive app")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--scene", default="cornell_box",
                    help="a scene name or an .obj path")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--output-dir", default=None,
                    help="where 'Render to file' writes (default: cge_out "
                    "in the temporary directory)")
    ap.add_argument("--data-dir", default=DEFAULT_DATA_DIR,
                    help="the reference's data directory, which every "
                    "prebuilt scene but spheres reads")
    ap.add_argument("--device", default=None,
                    help="torch device to render on (default: the card)")
    args = ap.parse_args(argv)
    try:
        state = AppState(scene=args.scene, width=args.size,
                         height=args.size, output_dir=args.output_dir,
                         data_dir=args.data_dir, device=args.device)
    except FileNotFoundError as e:
        ap.error(str(e))
    serve(state, port=args.port)


if __name__ == "__main__":
    main()
