"""cge_tpu_torch: the PyTorch and CUDA port of cge_tpu.

The Whitted chain (Phong shading, hard and transparency shadows from point
lights, soft shadows from segment and parallelogram lights, recursive
mirrors, interpolated normals, textures), the transparency + recursion
tree and glossy reflections, with MSAA, depth of field and bloom, render
on one device given to the scene loader, one camera or a batch, with the
cluster accel or without it, and train through the same trace
(diff.gradients). Their samples come from threefry streams equal to
jax.random's (ops/rng.py). Its three hot kernels, the cluster key pass and the
ordered cluster walk (csrc/cluster_sweep.cu) and the brute-force sweep
(csrc/sweep.cu), are hand-written CUDA for Hopper; on CPU tensors their
plain PyTorch twins run. Around the renderer: the TOML config and the CLI
(config.py, cli.py), the reference-parity BVH and its traversal
(ops/bvh.py, ops/bvh_traverse.py), the debug views (viz), the rasterized
preview (raster), the interactive app (app), and profiling and checkpoints
(utils). The package imports torch and numpy, never JAX.
"""

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.config import CameraConfig, Config, read_config_file
from cge_tpu_torch.diff.gradients import (DIFF_FIELDS, loss_and_grads,
                                          render_loss, scene_params,
                                          sgd_step, with_params)
from cge_tpu_torch.render.renderer import (RenderContext, prepare_render,
                                           render_image, render_image_u8,
                                           render_images, render_images_u8,
                                           stack_cameras)
from cge_tpu_torch.scene.scene import (PointLight, SceneArrays, SceneType,
                                       load_scene_from_file,
                                       load_scene_prebuilt)
from cge_tpu_torch.types import Features, RenderParams

__all__ = [
    "Camera", "CameraConfig", "Config", "DIFF_FIELDS", "Features",
    "PointLight", "RenderContext",
    "RenderParams", "SceneArrays", "SceneType", "load_scene_from_file",
    "load_scene_prebuilt", "loss_and_grads", "prepare_render",
    "read_config_file", "render_image",
    "render_image_u8", "render_images", "render_images_u8", "render_loss",
    "scene_params", "sgd_step", "stack_cameras", "with_params",
]
