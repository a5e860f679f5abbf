"""Command-line renderer (counterpart of cge_tpu/cli.py:39-118).

The CLI branch of the reference's main (src/main.cpp:478-535): the config
echo, the scene (a prebuilt registry scene from the config's data_path, or
an .obj path with the config's lights), one render a camera through one
prepared RenderContext, timestamped BMP names
`{scene}_{YYYY-MM-DD-HH:MM:SS}_cam_{i}.bmp` (main.cpp:510, 521-524) and
the total wall-clock print (main.cpp:532-534).

Usage: python -m cge_tpu_torch.cli [--device DEV] [config.toml]

The device is the card unless --device names another (`--device cpu` runs
the kernels' plain twins); without a card the default raises. With no
config, the default scene renders with a default camera (main.cpp:48-53).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

from cge_tpu_torch.config import CameraConfig, Config, read_config_file
from cge_tpu_torch.render.renderer import (prepare_render, render_image,
                                           render_images, stack_cameras)
from cge_tpu_torch.scene.image_io import write_bmp
from cge_tpu_torch.scene.scene import (SceneType, load_scene_from_file,
                                       load_scene_prebuilt, resolve_device,
                                       serialize_scene_type)
from cge_tpu_torch.types import RenderParams


def run(config: Config, params: RenderParams | None = None,
        device=None) -> list:
    """Render every camera of the config on `device` (resolve_device: the
    card by default); returns the written file paths."""
    device = resolve_device(device)
    params = params or RenderParams()
    if isinstance(config.scene, SceneType):
        scene = load_scene_prebuilt(config.scene, config.data_path,
                                    device=device)
        scene_name = serialize_scene_type(config.scene)
    else:
        scene = load_scene_from_file(config.scene, config.lights,
                                     device=device)
        scene_name = os.path.splitext(os.path.basename(config.scene))[0]

    os.makedirs(config.output_dir, exist_ok=True)   # main.cpp:505-507
    w, h = config.window_size
    start = time.perf_counter()
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H:%M:%S")

    cams = [c.to_camera(aspect=w / h) for c in config.cameras]
    # one prepared context for every camera: the reference's one BVH for
    # all its camera threads (main.cpp:502, 512-531)
    ctx = prepare_render(scene, config.features, params)
    if len(cams) > 1:
        imgs = render_images(scene, stack_cameras(cams), config.features,
                             params, w, h, 0, ctx)
    else:
        imgs = render_image(scene, cams[0], config.features, params, w, h,
                            0, ctx)[None]
    imgs = imgs.cpu().numpy()

    paths = []
    for i in range(len(cams)):
        filepath = os.path.join(config.output_dir,
                                f"{scene_name}_{stamp}_cam_{i}.bmp")
        print(f"Image {i} saved to {filepath}")     # main.cpp:523
        write_bmp(filepath, imgs[i])
        paths.append(filepath)

    elapsed_ms = int((time.perf_counter() - start) * 1000)
    print(f"Rendering took {elapsed_ms} ms, {len(config.cameras)} images "
          f"rendered.")                             # main.cpp:532-534
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cge_tpu_torch.cli",
                                 description="Render a TOML config's "
                                 "cameras into BMP files.")
    ap.add_argument("--device", default=None,
                    help="torch device to render on (default: the card)")
    ap.add_argument("config", nargs="?", help="TOML config file")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    if args.config:                                 # main.cpp:48-53
        config = read_config_file(args.config)
    else:
        config = Config(cli_rendering_enabled=True)
        config.cameras.append(CameraConfig())
        config.output_dir = os.getcwd()

    print(config)                                   # main.cpp:480
    if not config.cli_rendering_enabled:
        print("WARN: the interactive mode runs as python -m "
              "cge_tpu_torch.app; rendering headless instead.",
              file=sys.stderr)
    if not config.cameras:
        config.cameras.append(CameraConfig())
    run(config, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
