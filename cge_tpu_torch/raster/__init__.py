"""The rasterized preview (counterpart of cge_tpu/raster): the reference's
fixed-function OpenGL view (src/main.cpp:380-464, 540-658) as GL-convention
matrices, GL vertex lighting, a z-buffered edge-function rasterizer and
deferred Gouraud shading in torch ops."""

from cge_tpu_torch.raster.lighting import gl_point_lights, gl_vertex_colors
from cge_tpu_torch.raster.matrices import (look_at, perspective,
                                           project_vertices)
from cge_tpu_torch.raster.preview import render_preview
from cge_tpu_torch.raster.rasterize import rasterize, shade_gouraud

__all__ = [
    "look_at", "perspective", "project_vertices",
    "gl_point_lights", "gl_vertex_colors",
    "rasterize", "shade_gouraud",
    "render_preview",
]
