"""cge_tpu_torch: the PyTorch and CUDA port of cge_tpu.

The Whitted chain (Phong shading, hard shadows from point lights, recursive
mirrors, interpolated normals) renders on one device given to the scene
loader, with the cluster accel or without it, and trains through the same
trace (diff.gradients). Its three hot kernels, the cluster key pass and the
ordered cluster walk (csrc/cluster_sweep.cu) and the brute-force sweep
(csrc/sweep.cu), are hand-written CUDA for Hopper; on CPU tensors their
plain PyTorch twins run. The package imports torch and numpy, never JAX.
"""

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.diff.gradients import (DIFF_FIELDS, loss_and_grads,
                                          render_loss, scene_params,
                                          sgd_step, with_params)
from cge_tpu_torch.render.renderer import (RenderContext, prepare_render,
                                           render_image, render_image_u8)
from cge_tpu_torch.scene.scene import (PointLight, SceneArrays, SceneType,
                                       load_scene_from_file,
                                       load_scene_prebuilt)
from cge_tpu_torch.types import Features, RenderParams

__all__ = [
    "Camera", "DIFF_FIELDS", "Features", "PointLight", "RenderContext",
    "RenderParams", "SceneArrays", "SceneType", "load_scene_from_file",
    "load_scene_prebuilt", "loss_and_grads", "prepare_render", "render_image",
    "render_image_u8", "render_loss", "scene_params", "sgd_step",
    "with_params",
]
