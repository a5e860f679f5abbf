"""cge_tpu_torch: the PyTorch and CUDA port of cge_tpu.

The headline render (cluster-accelerated Whitted chain: Phong shading, hard
shadows from point lights, recursive mirrors, interpolated normals) runs on
one device given to the scene loader. Its two hot kernels, the cluster key
pass and the ordered cluster walk, are hand-written CUDA for Hopper
(csrc/cluster_sweep.cu); on CPU tensors their plain PyTorch twins run.
The package imports torch and numpy, never JAX.
"""

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.render.renderer import (RenderContext, prepare_render,
                                           render_image, render_image_u8)
from cge_tpu_torch.scene.scene import (PointLight, SceneArrays, SceneType,
                                       load_scene_from_file,
                                       load_scene_prebuilt)
from cge_tpu_torch.types import Features, RenderParams

__all__ = [
    "Camera", "Features", "PointLight", "RenderContext", "RenderParams",
    "SceneArrays", "SceneType", "load_scene_from_file", "load_scene_prebuilt",
    "prepare_render", "render_image", "render_image_u8",
]
