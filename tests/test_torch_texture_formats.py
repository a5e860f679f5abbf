"""TIFF, WebP and DDS textures through the whole port against the JAX
package: the 41x32 stand-in (tools/common.write_textured_obj) with its
body's `map_Kd` pointed at its seeded texels saved by Pillow as an LZW
TIFF with predictor 2, a Deflate TIFF, an LZMA TIFF with predictor 2, a
ZSTD TIFF, a bilevel Group 4 TIFF, a lossless WebP, a lossy WebP, and
DXT1, DXT5, BC5 (red and green, blue 0) and uncompressed RGBA DDS files,
and written as BC7 mode 6 blocks (jax_references/make_textures.bc7_mode6)
and as a tiled JPEG-in-TIFF of YCbCr 2x2 (make_textures.jpeg_tiff).
JAX loads the scene through Pillow (cge_tpu.load_scene_from_file), the
port through its own decoders (scene/tiff.py, webp.py and dds.py, with
device="cpu"): every
tensor of the scene, the texel stack among them, is equal. The 32x32
textured render with the accel on (JAX's K1 and K2 in interpret mode, the
port's twins) meets test_torch_texture.py's rule: NaN masks agree and >=
99.5% of pixels are within rtol 1e-4 / atol 2e-4.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PIL

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import intersect as jint
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.tools.common import write_textured_obj
from jax_references import make_textures

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
FEATURES = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_texture_mapping=True,
                enable_bilinear_texture_filtering=True,
                enable_accel_structure=True)
# file name -> Pillow's save options (with the mode saved, RGB by
# default), or the writer of the file's bytes from the texels
FORMATS = {
    "kd_lzw_predictor2.tif": dict(format="TIFF", compression="tiff_lzw",
                                  tiffinfo={317: 2}),
    "kd_deflate.tif": dict(format="TIFF", compression="tiff_adobe_deflate"),
    "kd_lzma_predictor2.tif": dict(format="TIFF", compression="lzma",
                                   tiffinfo={317: 2}),
    "kd_zstd.tif": dict(format="TIFF", compression="zstd"),
    "kd_group4.tif": dict(format="TIFF", mode="1", compression="group4"),
    "kd_jpeg_ycbcr22_tiles.tif": dict(writer=lambda px: make_textures
                                      .jpeg_tiff(px, 6, tile=(16, 16),
                                                 subsampling=2)),
    "kd_lossless.webp": dict(format="WEBP", lossless=True),
    "kd_lossy.webp": dict(format="WEBP", quality=90),
    "kd_dxt1.dds": dict(format="DDS", pixel_format="DXT1"),
    "kd_dxt5.dds": dict(format="DDS", pixel_format="DXT5"),
    "kd_bc5.dds": dict(format="DDS", pixel_format="BC5"),
    "kd_rgba.dds": dict(format="DDS", mode="RGBA"),
    "kd_bc7.dds": dict(writer=make_textures.bc7_mode6),
}


def _compare(img, ref, min_frac=0.995):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = close.all(axis=-1).mean()
    assert frac >= min_frac, f"{frac:.4%} pixels close"


@pytest.fixture(scope="module", params=sorted(FORMATS))
def scenes(request, tmp_path_factory):
    """(name, JAX scene, port scene as loaded, port scene on JAX's
    arrays) of the stand-in textured by one format's file."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name.replace(".", "_"))
    obj = str(tmp / "dragon.obj")
    png = write_textured_obj(obj, 41, 32)
    opts = dict(FORMATS[name])
    with PIL.open(png) as im:
        rgb = im.convert(opts.pop("mode", "RGB"))
        if "writer" in opts:
            with open(tmp / name, "wb") as f:
                f.write(opts["writer"](np.asarray(rgb)))
        else:
            rgb.save(str(tmp / name), opts.pop("format"), **opts)
    mtl = os.path.splitext(obj)[0] + ".mtl"
    with open(mtl) as f:
        text = f.read()
    with open(mtl, "w") as f:
        f.write(text.replace(os.path.basename(png), name))
    os.remove(png)
    js = cge_tpu.load_scene_from_file(obj, [JPointLight(*LIGHT)])
    loaded = ct.load_scene_from_file(obj, [ct.PointLight(*LIGHT)],
                                     device="cpu")
    # the same cluster permutation on both sides for the renders
    ps = scene_from_numpy({k: np.asarray(getattr(js, k))
                           for k in TENSOR_FIELDS},
                          all_opaque=js.all_opaque,
                          all_diffuse=js.all_diffuse, device="cpu")
    return name, js, loaded, ps


def test_scene_tensors_equal_jax(scenes):
    """Every tensor of the loaded scene equals JAX's, the texel stack
    (u8 / 255 as float32) among them, and the body is textured by the
    file's texels."""
    name, js, loaded, _ = scenes
    for k in TENSOR_FIELDS:
        if k != "cluster_perm":
            np.testing.assert_array_equal(
                getattr(loaded, k).numpy(),
                np.asarray(getattr(js, k)).astype(getattr(loaded, k).numpy()
                                                  .dtype), f"{name}: {k}")
    tex = [k for k in TENSOR_FIELDS if "tex" in k]
    assert tex and any(getattr(loaded, k).numel() > 1000 for k in tex)


def test_accel_render_matches_jax(scenes, monkeypatch):
    """The 32x32 textured frame with the accel on against JAX's (its
    cluster kernels in interpret mode), and not the untextured frame."""
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    name, js, _, ps = scenes
    params = dict(trace_chunk=512)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**FEATURES),
        cge_tpu.RenderParams(**params), 32, 32))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**FEATURES),
                          ct.RenderParams(**params), 32, 32).numpy()
    assert np.nanmax(ref) > 0.05, name
    _compare(img, ref)
    plain = ct.render_image(ps, ct.Camera(), ct.Features(
        **{**FEATURES, "enable_texture_mapping": False}),
        ct.RenderParams(**params), 32, 32).numpy()
    assert np.nanmax(np.abs(plain - img)) > 0.05, name
