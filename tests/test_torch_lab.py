"""The port's Lab -> sRGB transform (cge_tpu_torch/scene/lcms.py, LittleCMS
2.17's as Pillow 12.1's convert("RGB") builds it) against Pillow: every one
of the 2^24 8-bit Lab triples, in eight ranges of L so that no case runs
long; and the two formats that reach it, TIFF photometric 8 (II and MM, raw,
compressed and in planes, Pillow's own save) and PSD colour mode 9 (raw
and PackBits), against JAX's `load_image`. Pixels must be equal exactly."""

import io

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch.scene import lcms, mesh_io
from jax_references import make_textures as mt

L_RANGES = [(lo, lo + 32) for lo in range(0, 256, 32)]


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


@pytest.mark.parametrize("lo,hi", L_RANGES,
                         ids=[f"L{lo}-{hi - 1}" for lo, hi in L_RANGES])
def test_every_lab_triple_matches_pillow(lo, hi):
    """L in [lo, hi) against every a and b: Pillow's LAB bands (L, a + 128,
    b + 128) merged as they are, converted by Pillow and by the port."""
    v = np.arange(256, dtype=np.uint8)
    lab = np.stack(np.meshgrid(np.arange(lo, hi, dtype=np.uint8), v, v,
                               indexing="ij"), -1).reshape(-1, 256, 3)
    bands = [PIL.fromarray(np.ascontiguousarray(lab[..., k]))
             for k in range(3)]
    want = np.asarray(PIL.merge("LAB", bands).convert("RGB"))
    got = lcms.lab_to_rgb(lab)
    diff = np.abs(got.astype(np.int32) - want)
    assert int((diff.max(-1) > 0).sum()) == 0, (
        f"{int((diff.max(-1) > 0).sum())} triples differ, by up to "
        f"{int(diff.max())}")


def test_white_is_not_patched():
    """The resampled CLUT holds 33^3 16-bit nodes. Lab's white (0xFFFF,
    0x8080, 0x8080) lies between nodes of that grid, so LittleCMS's
    white-point fix-up patches none, and white comes out as the
    interpolation gives it: (254, 255, 254), in Pillow as in the port."""
    table = lcms.clut()
    assert table.shape == (lcms.GRID ** 3, 3)
    assert table.min() >= 0 and table.max() <= 65535
    assert (0x8080 * (lcms.GRID - 1)) % 0xFFFF != 0
    lab = np.array([[[255, 128, 128], [0, 128, 128]]], np.uint8)
    want = np.asarray(PIL.merge("LAB", [PIL.fromarray(lab[..., k])
                                        for k in range(3)]).convert("RGB"))
    np.testing.assert_array_equal(lcms.lab_to_rgb(lab), want)
    assert want[0, 0].tolist() == [254, 255, 254]


def _lab_samples(rng, h, w):
    """TIFF CIELab samples: L unsigned, a* and b* signed bytes (as uint8
    two's complement)."""
    px = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    px[0, 0] = (255, 0, 0)                     # white
    px[-1, -1] = (0, 0, 0)                     # black
    return px


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", ["raw", "lzw", "deflate", "packbits",
                                    "planar", "tiles"])
def test_lab_tiff_matches_jax(tmp_path, order, layout):
    """Photometric 8, 8-8-8 bits, II and MM: Pillow's LAB unpacker
    (a* and b* signed, offset by 128; a plane's bytes as they are), then
    LittleCMS."""
    rng = np.random.default_rng(len(layout) * 2 + (order == ">"))
    px = _lab_samples(rng, 9, 13)
    kw = {"raw": {}, "lzw": {"compression": 5},
          "deflate": {"compression": 8, "predictor": 2},
          "packbits": {"compression": 32773},
          "planar": {"planar": 2, "compression": 8},
          "tiles": {"tile": (16, 16)}}[layout]
    path = str(tmp_path / "lab.tif")
    with open(path, "wb") as f:
        f.write(mt.tiff_file(px, 8, 8, order=order, **kw))
    want = _jax_u8(path)
    np.testing.assert_array_equal(_port_u8(path), want)


def test_pillow_saved_lab_tiff_matches_jax(tmp_path):
    """Pillow's own LAB TIFF (its SAVE_INFO "LAB": II, photometric 8)."""
    rng = np.random.default_rng(3)
    bands = [PIL.fromarray(rng.integers(0, 256, (11, 7)).astype(np.uint8))
             for _ in range(3)]
    buf = io.BytesIO()
    PIL.merge("LAB", bands).save(buf, "TIFF")
    path = tmp_path / "pillow_lab.tif"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(_port_u8(str(path)), _jax_u8(str(path)))


@pytest.mark.parametrize("rle,channels", [(False, 3), (True, 3), (False, 4)])
def test_lab_psd_matches_jax(tmp_path, rle, channels):
    """PSD colour mode 9 at 8 bits: L, a and b planes (a and b offset by
    128, as Photoshop stores them), raw or PackBits, a fourth channel
    (alpha) of a raw file dropped."""
    rng = np.random.default_rng(7 + rle + 2 * channels)
    h, w = 6, 10
    planes = [rng.integers(0, 256, (h, w)).astype(np.uint8)
              for _ in range(channels)]
    path = tmp_path / "lab.psd"
    path.write_bytes(mt.psd_file(w, h, 9, 8, planes, rle=rle, rng=rng))
    want = _jax_u8(str(path))
    np.testing.assert_array_equal(_port_u8(str(path)), want)
    np.testing.assert_array_equal(
        want, lcms.lab_to_rgb(np.stack(planes[:3], -1)))
