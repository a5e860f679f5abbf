"""The port's texture decoders (cge_tpu_torch/scene/image_io.py: PNG and
BMP; scene/jpeg.py: JPEG; scene/tga.py, pnm.py, gif.py, psd.py, tiff.py,
webp.py and dds.py: TGA, PNM, GIF, PSD, TIFF, WebP and DDS; the
byte-serial parts in native/cge_image.cpp, native/cge_webp.cpp and
native/cge_bcn.cpp) against Pillow, which the JAX package's loader uses:
seeded numpy images of every colour type, every row filter and odd sizes,
written by the port's `write_png` and by Pillow; every fixture of
tests/torch_textures/ (jax_references/make_textures.py) against JAX's
`load_image`; random images Pillow saves in random PNG, BMP and JPEG
modes, in random TGA, GIF and PNM modes, and as random TIFF and WebP
files; seeded random DDS files of every block-compressed kind and random
RGB masks; the native PNG row filters against their Python twin; damaged
files of each format after PNG, BMP and JPEG. Pixels must be equal
exactly (u8 / 255 as float32, as stb_image and the JAX loader give
them)."""

import hashlib
import io
import json
import os
import struct
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, mesh_io
from jax_references import make_textures

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_textures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)

# samples a pixel -> the colour type write_png gives it
COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}


def _pillow_rgb(path):
    with PIL.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_each_colour_type_and_filter_matches_pillow(tmp_path, ch, filt):
    """Rows filtered with one filter type, or cycling through all five."""
    rng = np.random.default_rng(ch * 10 + (filt if isinstance(filt, int)
                                           else 9))
    px = rng.integers(0, 256, (13, 7, ch), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, px if ch > 1 else px[..., 0],
                       filters=filt if isinstance(filt, tuple) else (filt,))
    with open(path, "rb") as f:
        assert f.read(26)[25] == COLOUR[ch]
    img = image_io.load_image(path)
    want = _pillow_rgb(path)
    assert (img.width, img.height) == (7, 13)
    assert img.pixels.dtype == np.float32
    np.testing.assert_array_equal(img.pixels,
                                  want.astype(np.float32) / 255.0)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 17), (31, 2), (64, 96)])
def test_palette_images_match_pillow(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    palette = rng.integers(0, 256, (23, 3), dtype=np.uint8)
    idx = rng.integers(0, 23, (h, w), dtype=np.uint8)
    path = str(tmp_path / "p.png")
    image_io.write_png(path, idx, filters=(0, 1, 2, 3, 4), palette=palette)
    np.testing.assert_array_equal(
        image_io.decode_png(open(path, "rb").read()), _pillow_rgb(path))
    np.testing.assert_array_equal(_pillow_rgb(path), palette[idx])


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_pillow_written_files_decode(tmp_path, mode):
    """Files Pillow writes, with its own filter choices."""
    rng = np.random.default_rng(len(mode))
    im = PIL.fromarray(rng.integers(0, 256, (29, 33, 3), dtype=np.uint8))
    path = str(tmp_path / f"{mode}.png")
    im.convert(mode).save(path)
    np.testing.assert_array_equal(
        image_io.decode_png(open(path, "rb").read()), _pillow_rgb(path))


def test_write_png_round_trips(tmp_path):
    """Float radiance is quantised as the image writer does (to_u8: NaN ->
    0, clamp, x255, truncate), then reads back exactly."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    img[0, 0, 1] = np.nan
    path = str(tmp_path / "r.png")
    image_io.write_png(path, img, filters=(4, 3))
    back = image_io.load_image(path).pixels
    u8 = image_io.to_u8(img)
    np.testing.assert_array_equal(back, u8.astype(np.float32) / 255.0)
    assert u8[0, 0, 1] == 0 and back.shape == (9, 11, 3)


def _header(path, depth, ctype, interlace):
    body = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
    chunk = make_textures._chunk(b"IHDR", body)
    with open(path, "wb") as f:
        f.write(image_io.SIGNATURE + chunk)


@pytest.mark.parametrize("depth,ctype,interlace,words", [
    (16, 3, 0, "16-bit palette PNG"), (3, 0, 0, "3-bit grey PNG"),
    (8, 2, 2, "8-bit RGB PNG with interlace method 2"),
    (8, 5, 0, "PNG colour type 5")])
def test_unsupported_pngs_name_their_format(tmp_path, depth, ctype,
                                            interlace, words):
    """PNGs that the spec does not allow raise, naming their format (the
    formats this test named before now decode:
    test_formerly_unsupported_pngs_decode)."""
    path = str(tmp_path / "x.png")
    _header(path, depth, ctype, interlace)
    with pytest.raises(ValueError, match=words):
        image_io.load_image(path)


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


@pytest.mark.parametrize("depth,ctype,interlace", [
    (16, 2, 0), (16, 0, 0), (8, 6, 1), (4, 3, 0)])
def test_formerly_unsupported_pngs_decode(tmp_path, depth, ctype,
                                          interlace):
    """16-bit RGB and grey, Adam7 RGBA and 4-bit palette PNGs, which the
    port refused before, decode to JAX's pixels."""
    rng = np.random.default_rng(depth * 10 + ctype)
    ch = make_textures._CHANNELS[ctype]
    px = rng.integers(0, 1 << depth, (7, 9, ch))
    palette = rng.integers(0, 256, (16, 3)) if ctype == 3 else None
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(make_textures.png_file(px, depth, ctype, bool(interlace),
                                       palette))
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


@pytest.mark.parametrize("name", [f["name"] for f in MANIFEST["files"]])
def test_fixture_matches_jax(name):
    """Every fixture: the port's pixels equal JAX's load_image's after u8
    quantisation (tolerance 0), and the manifest's hash."""
    entry = next(f for f in MANIFEST["files"] if f["name"] == name)
    path = os.path.join(FIXTURES, name)
    port, ref = _port_u8(path), _jax_u8(path)
    assert list(port.shape) == entry["shape"]
    np.testing.assert_array_equal(port, ref)
    assert hashlib.sha256(port.tobytes()).hexdigest() == entry["sha256"]


def test_fixtures_cover_every_kind():
    """The manifest names every PNG depth and colour type, plain and
    Adam7, each BMP kind, the JPEG kinds, every TGA kind in each
    orientation and run-length, P1 to P6 at each maxval case, the GIF
    table, interlace, offset and transparency cases, every PSD colour
    mode raw and PackBits, every TIFF mode in each compression with the
    predictor, planar, tile, fill order, byte order, BigTIFF, old-style
    LZW and orientation cases, and the WebP lossy filter, segment,
    partition and alpha cases, the lossless palettes and the animations,
    and every DDS kind Pillow reads (Pillow's own files, BC1 to BC7 with
    each BC1 colour mode, BC3 alpha mode, BC6H and BC7 mode, the DX10
    forms, the RGB masks, the palette, crops and surfaces past the first);
    the set stays under 1 MB with the 1024x1024 progressive JPEG, its
    texels as a 1024x1024 lossy WebP and their lossless crop in it."""
    names = {f["name"] for f in MANIFEST["files"]}
    for kind in ("cmap24", "cmap16", "rgb16", "rgb24", "rgba32", "grey8",
                 "grey_alpha16", "grey1"):
        for corner in make_textures.ORIENTATIONS.values():
            assert f"tga_{kind}_{corner}.tga" in names
        assert kind == "grey1" or any(
            n.startswith(f"tga_{kind}_rle_") for n in names)
    assert {"tga_rgb24_image_id.tga", "tga_grey8_colour_map.tga",
            "tga_pillow_rgb_rle.tga", "tga_pillow_p.tga"} <= names
    for magic, ext in (("p2", "pgm"), ("p3", "ppm")):
        for maxval in (15, 255, 1000, 65535):
            assert f"pnm_{magic}_maxval{maxval}.{ext}" in names
    for magic, ext in (("p5", "pgm"), ("p6", "ppm")):
        for maxval in (1, 15, 255, 1000, 65535):
            assert f"pnm_{magic}_maxval{maxval}.{ext}" in names
    assert {"pnm_p1.pbm", "pnm_p1_packed.pbm", "pnm_p4.pbm",
            "pnm_pillow_p5_16bit.pgm"} <= names
    assert {f"gif_{k}.gif" for k in (
        "pillow", "pillow_interlaced", "global_table", "local_table",
        "interlaced", "offset", "offset_transparent", "past_the_screen",
        "no_table", "ramp_table", "local_ramp_table", "index_past_table",
        "clear_codes", "full_code_table", "extensions")} <= names
    for mode in ("bitmap", "grey", "indexed", "rgb", "rgba", "cmyk",
                 "multichannel", "duotone"):
        assert {f"psd_{mode}_raw.psd", f"psd_{mode}_rle.psd"} <= names
    for ctype, depths in {"grey": (1, 2, 4, 8, 16), "rgb": (8, 16),
                          "palette": (1, 2, 4, 8), "grey_alpha": (8, 16),
                          "rgba": (8, 16)}.items():
        for d in depths:
            assert {f"png_{ctype}_{d}bit.png",
                    f"png_{ctype}_{d}bit_adam7.png"} <= names
    for mode in ("baseline", "progressive"):
        assert {f"jpeg_{mode}_{k}.jpg" for k in (
            "444", "422", "420", "grey", "adobe_rgb", "adobe_ycc",
            "420_restart", "422_restart_rows")} <= names
    assert {"bmp_1bit_core.bmp", "bmp_4bit_rle4.bmp", "bmp_8bit_rle8.bmp",
            "bmp_16bit_555.bmp", "bmp_16bit_565_bitfields.bmp",
            "bmp_24bit_top_down.bmp", "bmp_32bit_bitfields_v5.bmp",
            make_textures.BIG} <= names
    big = next(f for f in MANIFEST["files"] if f["name"] == make_textures.BIG)
    assert big["shape"] == [1024, 1024, 3]
    tiff_modes = (
        "bilevel", "bilevel_min_is_white", "grey2", "grey2_min_is_white",
        "grey4", "grey4_min_is_white", "grey8", "grey8_min_is_white",
        "grey8_signed", "grey12", "grey16", "grey16_min_is_white",
        "grey16_signed", "grey32", "grey32_signed", "float",
        "float_min_is_white", "grey_alpha", "rgb", "rgba",
        "rgba_no_extra_samples", "rgba_associated", "rgba_corel", "rgbx",
        "rgbxx", "rgba_associated_x", "rgba_x_x", "rgb16", "rgba16",
        "rgba16_associated", "rgbx16", "palette1", "palette2", "palette4",
        "palette8", "palette_x", "palette_alpha", "cmyk", "cmykx", "cmyk16")
    for mode in tiff_modes:
        assert {f"tiff_{mode}_{c}.tif" for c in make_textures
                .TIFF_COMPRESSIONS} <= names, mode
    assert {"tiff_float_lzw_predictor3.tif",
            "tiff_float_be_lzw_predictor3.tif",
            "tiff_grey16_be_deflate_predictor2.tif",
            "tiff_grey32_signed_lzw_predictor2.tif",
            "tiff_rgb_planar_lzw.tif",
            "tiff_rgba_associated_planar_deflate.tif",
            "tiff_rgb_tiles_lzw_predictor2.tif",
            "tiff_rgb_tiles_deflate_planar.tif",
            "tiff_rgb_fill_order2_lzw.tif",
            "tiff_bilevel_fill_order2_packbits.tif",
            "tiff_rgb_bigtiff_lzw.tif", "tiff_rgb_lzw_old_style.tif",
            "tiff_float_be_raw.tif", "tiff_grey16_signed_be_lzw.tif",
            "tiff_pillow_rgb_lzw_predictor2.tif"} <= names
    assert {f"tiff_rgb_orientation{k}.tif" for k in range(2, 9)} <= names
    for k in ("11x13", "33x17", "1x1", "100x5", "simple_filter",
              "simple_filter_sharpness7", "strong_filter_sharpness3",
              "no_filter", "one_segment", "two_segments", "four_partitions",
              "eight_partitions", "alpha", "alpha_raw", "alpha_best_filter",
              "alpha_quantised"):
        assert f"webp_lossy_{k}.webp" in names, k
    for f in range(4):
        assert {f"webp_lossy_alph_raw_filter{f}.webp",
                f"webp_lossy_alph_vp8l_filter{f}.webp"} <= names
    assert {f"webp_lossless_palette{k}.webp" for k in (2, 4, 16, 256)} <= \
        names
    assert {"webp_lossless_method6.webp", "webp_lossless_alpha.webp",
            "webp_lossless_near_lossless.webp", "webp_animated_lossy.webp",
            "webp_animated_lossless.webp", "webp_animated_offset_frame.webp",
            make_textures.WEBP_BIG, make_textures.WEBP_CROP_NAME} <= names
    webp_big = next(f for f in MANIFEST["files"]
                    if f["name"] == make_textures.WEBP_BIG)
    assert webp_big["shape"] == [1024, 1024, 3]
    dds = {f"dds_pillow_{k}" for k in (
        "dxt1", "dxt3", "dxt5", "bc2", "bc3", "bc5", "l", "la", "rgb", "rgba")}
    dds |= {"dds_dxt1_four_colour", "dds_dxt1_three_colour",
            "dds_dxt5_alpha8", "dds_dxt5_alpha6", "dds_bc4_ati1",
            "dds_bc4_bc4u", "dds_bc5_ati2", "dds_bc5_bc5u", "dds_bc5_bc5s",
            "dds_bc6h_uf16", "dds_bc6h_sf16", "dds_bc7_no_mode",
            "dds_bc7_srgb", "dds_dx10_bc5_snorm", "dds_palette8",
            "dds_dxt1_1x1", "dds_dxt5_5x3", "dds_bc7_13x9",
            "dds_dxt1_mipmaps", "dds_dxt5_cube", "dds_dx10_bc7_array2"}
    dds |= {f"dds_bc7_mode{m}" for m in range(8)}
    dds |= {f"dds_dx10_bc{k}_{form}" for k in range(1, 6)
            for form in ("typeless", "unorm")}
    dds |= {f"dds_dx10_r8g8b8a8_{form}" for form in ("typeless", "unorm",
                                                      "srgb")}
    dds |= {f"dds_{k}" for k in (
        "rgb16_565", "rgb16_1555", "rgb16_4444", "rgb24", "rgb32_a8r8g8b8",
        "rgb32_x8r8g8b8", "rgb32_a8b8g8r8", "rgb32_a2r10g10b10",
        "rgb32_zero_mask")}
    assert {f"{k}.dds" for k in dds} <= names
    shapes = {f["name"]: f["shape"] for f in MANIFEST["files"]}
    assert shapes["dds_bc7_13x9.dds"] == [9, 13, 3]
    assert shapes["dds_dxt5_5x3.dds"] == [3, 5, 3]
    assert sum(f["bytes"] for f in MANIFEST["files"]) < 1 << 20


_PNG_MODES = ["1", "L", "P", "P;1", "P;2", "P;4", "RGB", "RGBA", "LA",
              "I;16"]
_BMP_MODES = ["1", "L", "P", "RGB", "RGBA"]


def _pillow_bytes(rng, fmt, mode, h, w, opts):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if fmt == "JPEG":
        # smooth content with noise, as textures are
        y, x = np.mgrid[0:h, 0:w]
        base = 120 + 80 * np.sin(x[..., None] / 4.0 + np.arange(3)) * \
            np.cos(y[..., None] / 6.0)
        rgb = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
            np.uint8)
    im = PIL.fromarray(rgb)
    kw = {}
    if mode == "I;16":
        im = PIL.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    elif mode.startswith("P;"):
        bits = int(mode[2:])
        im = PIL.fromarray(rng.integers(0, 1 << bits, (h, w)).astype(
            np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 << bits).tolist())
        kw["bits"] = bits
    else:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw, **opts)
    return buf.getvalue()


@st.composite
def _pillow_files(draw):
    fmt = draw(st.sampled_from(["PNG", "BMP", "JPEG"]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    opts = {}
    if fmt == "PNG":
        mode = draw(st.sampled_from(_PNG_MODES))
    elif fmt == "BMP":
        mode = draw(st.sampled_from(_BMP_MODES))
    else:
        mode = draw(st.sampled_from(["L", "RGB"]))
        opts = dict(quality=draw(st.integers(5, 100)),
                    progressive=draw(st.booleans()),
                    restart_marker_blocks=draw(st.sampled_from([0, 1, 5])))
        if mode == "RGB":
            opts["subsampling"] = draw(st.sampled_from([0, 1, 2]))
            # Pillow writes Adobe RGB unsubsampled only
            opts["keep_rgb"] = opts["subsampling"] == 0 and draw(
                st.booleans())
    seed = draw(st.integers(0, 2 ** 32 - 1))
    return fmt, mode, h, w, opts, seed


@pytest.fixture(scope="module")
def scratch_dir():
    with tempfile.TemporaryDirectory() as d:
        yield d


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=_pillow_files())
def test_random_pillow_files_match_jax(scratch_dir, case):
    """Random small images that Pillow saves in a random PNG, BMP or JPEG
    mode (JPEG: quality, progressive, restart interval, sampling, Adobe
    RGB) decode to JAX's pixels exactly; the file is named .tex, so the
    signature picks the decoder."""
    fmt, mode, h, w, opts, seed = case
    data = _pillow_bytes(np.random.default_rng(seed), fmt, mode, h, w,
                         opts)
    path = os.path.join(scratch_dir, "case.tex")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


def test_palette_index_past_the_end_is_black(tmp_path):
    """Indices [0, 1, 2, 7] against a 2-entry palette: JAX (Pillow) gives
    black past the palette's end, and so does the port."""
    palette = np.array([[10, 20, 30], [40, 50, 60]])
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(make_textures.png_file(np.array([[0, 1, 2, 7]]), 8, 3,
                                       palette=palette))
    want = np.array([[[10, 20, 30], [40, 50, 60], [0, 0, 0], [0, 0, 0]]],
                    np.uint8)
    np.testing.assert_array_equal(_jax_u8(path), want)
    np.testing.assert_array_equal(_port_u8(path), want)


@pytest.mark.parametrize("fixture,name", [
    ("png_rgb_8bit.png", "texture.jpg"),
    ("jpeg_baseline_420.jpg", "texture.png"),
    ("bmp_24bit.bmp", "texture.tex"),
    ("tga_cmap24_top_left.tga", "texture.png"),
    ("tga_rgb24_rle_top_right.tga", "texture.bmp"),
    ("pnm_p3_maxval1000.ppm", "texture.tga"),
    ("pnm_p6_maxval65535.ppm", "texture.jpg"),
    ("gif_offset_transparent.gif", "texture.psd"),
    ("psd_cmyk_rle.psd", "texture.gif"),
    ("tiff_rgb_lzw_predictor2.tif", "texture.png"),
    ("webp_lossy_alpha.webp", "texture.tif"),
    ("dds_bc7_mode6.dds", "texture.png")])
def test_swapped_extensions_decode_by_signature(tmp_path, fixture, name):
    """A PNG named .jpg, a JPEG named .png, a BMP named .tex, and TGA,
    PNM, GIF, PSD, TIFF, WebP and DDS files under other formats' names load
    through the mesh loader's texture path as JAX loads them."""
    path = str(tmp_path / name)
    with open(os.path.join(FIXTURES, fixture), "rb") as src, \
            open(path, "wb") as dst:
        dst.write(src.read())
    np.testing.assert_array_equal(
        np.rint(mesh_io.load_image(path).pixels * 255).astype(np.uint8),
        _jax_u8(path))


def _jpeg_with(tweak):
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    PIL.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=80, subsampling=0)
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    tweak(data, sof)
    return bytes(data)


def _set(offset, value):
    def tweak(data, sof):
        data[sof + offset] = value
    return tweak


def _pillow_saved(fmt, mode="RGB", **kw):
    buf = io.BytesIO()
    PIL.new(mode, (4, 4), 90).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind,make,words", [
    ("arithmetic", lambda: _jpeg_with(_set(1, 0xC9)),
     r"arithmetic-coded JPEG \(SOF9\)"),
    ("lossless", lambda: _jpeg_with(_set(1, 0xC3)), r"lossless JPEG"),
    ("12-bit", lambda: _jpeg_with(_set(4, 12)), r"12-bit JPEG"),
    ("cmyk", lambda: _pillow_saved("JPEG", "CMYK"), r"CMYK"),
    ("440", lambda: _jpeg_with(_set(11, 0x12)), r"4:4:0"),
    ("411", lambda: _jpeg_with(_set(11, 0x41)), r"4:1:1"),
    ("tiff", lambda: _pillow_saved("TIFF", "1", compression="group4"),
     r"TIFF with CCITT Group 4 compression"),
    ("webp", lambda: _pillow_saved("TIFF", compression="jpeg"),
     r"TIFF with JPEG compression"),
    ("tiff_ycbcr", lambda: _pillow_saved("TIFF", "YCbCr",
                                         compression="tiff_lzw"),
     r"photometric 6 TIFF.*YCbCr"),
    ("tiff_lab", lambda: _pillow_saved("TIFF", "LAB"),
     r"photometric 8 TIFF.*L\*a\*b\* is not ported"),
    ("tiff_lzma", lambda: make_textures.tiff_file(
        np.zeros((2, 2, 1), np.uint8), 8, 1, compression=34925,
        raw_strips=[b"\0"]), r"TIFF with LZMA compression"),
    ("tiff_bigtiff_mm", lambda: make_textures.tiff_file(
        np.zeros((2, 2, 1), np.uint8), 8, 1, bigtiff=True, order=">"),
     r"TIFF"),
    ("gif", lambda: _pillow_saved("GIF")[:-8], r"GIF.*truncated"),
    ("dds", lambda: make_textures.dds_file(4, 4, bytes(8), fourcc=b"DXT2"),
     r"DDS.*DXT2"),
    ("pam", lambda: b"P7\nWIDTH 4\nHEIGHT 4\n", r"PAM"),
    ("psd_lab", lambda: make_textures.psd_file(
        2, 1, 9, 8, [np.zeros((1, 2), np.uint8)] * 3), r"LAB PSD"),
    ("bmp_jpeg", lambda: make_textures.bmp_file(1, 1, 24, b"\xff\xd8",
                                                compression=4), r"JPEG"),
    ("unknown", lambda: b"\x00\x01\x02\x03 no image", r"unknown format")])
def test_unsupported_formats_name_their_format(tmp_path, kind, make, words):
    """Formats the port does not read raise a ValueError that names them
    (ROADMAP queue 6 lists them in order), whatever the file's name: among
    them the TIFF compressions and photometrics left out (CCITT Group 4
    and JPEG in TIFF, in the cases named "tiff" and "webp" since the port
    reads both formats), and a big-endian BigTIFF, which Pillow reads as a
    classic TIFF and refuses; so does a GIF, which the port reads, cut
    short, and a DDS of the premultiplied DXT2, which Pillow refuses."""
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(ValueError, match=words):
        mesh_io.load_image(path)


def test_loader_decodes_png_without_pillow(tmp_path, monkeypatch):
    """The mesh loader's texture path with Pillow blocked: every fixture
    (every supported PNG, BMP and JPEG kind) decodes to JAX's pixels,
    computed before Pillow was blocked."""
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    files = [os.path.join(FIXTURES, f["name"]) for f in MANIFEST["files"]]
    want = {p: _jax_u8(p) for p in files}
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    for p in files:
        got = np.rint(mesh_io.load_image(p).pixels * 255).astype(np.uint8)
        np.testing.assert_array_equal(got, want[p], err_msg=p)


def test_not_a_png_raises(tmp_path):
    path = tmp_path / "n.png"
    path.write_bytes(b"qoif\x00\x00\x00\x04 a QOI header")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.load_image(str(path))


def _unfilter_twin(raw: bytes, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """The PNG row filters undone byte by byte in Python (PNG spec section
    9): the twin of native.png_unfilter."""
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = bytes(stride)
    for y in range(height):
        kind, cur = int(rows[y, 0]), bytearray(rows[y, 1:].tobytes())
        for x in range(stride):
            a = cur[x - bpp] if x >= bpp else 0
            b, c = prior[x], prior[x - bpp] if x >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            cur[x] = (cur[x] + pred) & 0xFF
        out[y] = np.frombuffer(bytes(cur), np.uint8)
        prior = bytes(cur)
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, None])
def test_native_unfilter_matches_python_twin(kind, bpp):
    """native.png_unfilter equals the byte-by-byte Python twin on random
    scanlines of each filter type (None: a random type a row) and each
    bytes-a-pixel of PNG, and raises on an unknown filter type."""
    rng = np.random.default_rng(bpp * 10 + (kind if kind is not None else 9))
    h, stride = 9, bpp * 7 + 3
    rows = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h) if kind is None else kind
    raw = rows.tobytes()
    np.testing.assert_array_equal(native.png_unfilter(raw, h, stride, bpp),
                                  _unfilter_twin(raw, h, stride, bpp))
    rows[4, 0] = 5
    with pytest.raises(ValueError, match="row 4 has unknown filter type 5"):
        native.png_unfilter(rows.tobytes(), h, stride, bpp)
    with pytest.raises(ValueError, match="truncated"):
        native.png_unfilter(raw[:-1], h, stride, bpp)


def _damaged(name, how):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    if how == "cut":
        return data[:len(data) * 2 // 3]
    if isinstance(how, int):                          # cut at that length
        return data[:how]
    if isinstance(how[0], bytes):
        return data.replace(*how, 1)
    data = bytearray(data)
    pos, value = how
    data[pos if pos >= 0 else len(data) + pos] = value
    return bytes(data)


@pytest.mark.parametrize("name,how,words", [
    ("tga_rgb24_top_left.tga", "cut", "TGA.*truncated"),
    ("tga_rgb24_rle_top_right.tga", "cut", "TGA.*truncated"),
    ("tga_cmap24_bottom_left.tga", "cut", "TGA.*truncated"),
    # the first packet a run of 128 pixels: past its row's end
    ("tga_rgb24_rle_top_right.tga", (18, 0xFF), "TGA run-length packet"),
    ("tga_cmap16_top_left.tga", (7, 32), "TGA.*32-bit colour map"),
    ("pnm_p6_maxval255.ppm", "cut", "P6 PNM.*truncated"),
    ("pnm_p3_maxval1000.ppm", "cut", "P3 PNM.*truncated"),
    ("pnm_p1_packed.pbm", (-1, ord("7")), "P1 PNM.*not 0 or 1"),
    ("pnm_p2_maxval15.pgm", (b"15\n7 ", b"15\nx "),
     "P2 PNM.*not a decimal"),
    ("gif_global_table.gif", "cut", "GIF.*truncated"),
    ("gif_interlaced.gif", (-4, 0xFF), "GIF"),
    ("gif_local_table.gif", (10, 0x00), "GIF"),
    ("psd_rgb_raw.psd", "cut", "PSD.*truncated"),
    ("psd_cmyk_rle.psd", "cut", "PSD.*truncated"),
    ("psd_grey_rle.psd", (23, 16), "16-bit.*PSD"),
    ("psd_rgb_raw.psd", (13, 2), "PSD.*not enough channels"),
    ("tiff_rgb_raw.tif", "cut", "TIFF.*truncated"),
    ("tiff_rgb_lzw.tif", "cut", "TIFF"),
    ("tiff_grey16_be_deflate_predictor2.tif", "cut", "TIFF"),
    ("tiff_cmyk_packbits.tif", "cut", "TIFF"),
    ("tiff_rgb_tiles_lzw_predictor2.tif", "cut", "TIFF"),
    # BitsPerSample 8 -> 3: a key Pillow does not know
    ("tiff_grey8_raw.tif", (b"\x02\x01\x03\x00\x01\x00\x00\x00\x08",
                            b"\x02\x01\x03\x00\x01\x00\x00\x00\x03"),
     "3-bit.*TIFF.*not a mode"),
    ("webp_lossy_11x13.webp", "cut", "WebP.*truncated"),
    ("webp_lossless_method6.webp", "cut", "WebP.*truncated"),
    ("webp_lossy_alpha.webp", "cut", "WebP.*truncated"),
    ("webp_animated_lossy.webp", "cut", "WebP.*truncated"),
    # the VP8 start code, the VP8L signature byte and version
    ("webp_lossy_33x17.webp", (b"\x9d\x01\x2a", b"\x9d\x01\x2b"),
     "WebP VP8 bitstream without a key-frame start code"),
    ("webp_lossless_exact.webp", (b"VP8L", b"VP8X"), "WebP"),
    # the ALPH header byte (after RIFF and VP8X) with its reserved bits set
    ("webp_lossy_alph_raw_filter1.webp", (38, 0xC4), "WebP.*ALPH header"),
    ("dds_pillow_dxt1.dds", "cut", "DDS DXT1.*truncated"),
    ("dds_bc7_mode6.dds", "cut", "DDS DX10 DXGI format 98.*truncated"),
    ("dds_bc6h_sf16.dds", "cut", "DDS DX10 DXGI format 96.*truncated"),
    ("dds_bc4_ati1.dds", 140, "DDS ATI1.*truncated"),
    ("dds_pillow_l.dds", "cut", "DDS 8-bit luminance.*truncated"),
    ("dds_palette8.dds", "cut", "DDS 8-bit palette.*truncated"),
    ("dds_dx10_r8g8b8a8_unorm.dds", "cut", "DDS.*DXGI format 28.*truncated"),
    ("dds_pillow_dxt5.dds", 100, "DDS header.*truncated"),
    ("dds_dx10_bc1_unorm.dds", 130, "DDS DX10 header.*truncated"),
    # the header size, the FourCC, the DXGI format, the flags, the depth
    ("dds_pillow_dxt1.dds", (4, 100), "DDS with a 100-byte header"),
    ("dds_pillow_dxt1.dds", (b"DXT1", b"DXT4"), "DDS.*FourCC 'DXT4'"),
    ("dds_dx10_bc4_unorm.dds", (128, 81), "DDS.*DXGI format 81"),
    ("dds_pillow_dxt1.dds", (80, 0), "DDS.*pixel format flags 0x0"),
    ("dds_pillow_l.dds", (88, 16), "DDS luminance at 16 bits without")])
def test_damaged_files_raise_naming_file_and_format(tmp_path, name, how,
                                                   words):
    """A truncated or corrupt TGA, PNM, GIF, PSD, TIFF, WebP or DDS
    raises a ValueError that names the file and the format (and so does
    JAX's loader: Pillow refuses each of them too); DDS files are cut at
    several lengths, from the header to the blocks, and refused for their
    header size, FourCC, DXGI format, flags and luminance depth."""
    path = str(tmp_path / "texture.bin")
    with open(path, "wb") as f:
        f.write(_damaged(name, how))
    with pytest.raises(ValueError, match=words) as e:
        mesh_io.load_image(path)
    assert path in str(e.value)
    with pytest.raises(Exception):
        jax_image_io.load_image(path)


@st.composite
def _new_format_files(draw):
    fmt = draw(st.sampled_from(["TGA", "GIF", "PPM"]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    opts = {}
    if fmt == "TGA":
        mode = draw(st.sampled_from(["L", "LA", "P", "RGB", "RGBA", "1"]))
        opts["rle"] = mode != "1" and draw(st.booleans())
        opts["orientation"] = draw(st.sampled_from([-1, 1]))
    elif fmt == "GIF":
        mode = draw(st.sampled_from(["L", "P", "RGB", "1"]))
        opts["interlace"] = draw(st.booleans())
    else:
        mode = draw(st.sampled_from(["1", "L", "RGB", "I;16"]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    return fmt, mode, h, w, opts, seed


@settings(max_examples=40, deadline=None, derandomize=True)
@given(case=_new_format_files())
def test_random_tga_gif_pnm_files_match_jax(scratch_dir, case):
    """Random small images that Pillow saves as TGA (each mode, raw or
    run-length, either orientation), GIF (each mode, interlaced or not)
    or PNM decode to JAX's pixels exactly; the file is named .tex."""
    fmt, mode, h, w, opts, seed = case
    data = _pillow_bytes(np.random.default_rng(seed), fmt, mode, h, w,
                         opts)
    path = os.path.join(scratch_dir, "case.tex")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


@st.composite
def _tiff_webp_files(draw):
    fmt = draw(st.sampled_from(["TIFF", "WEBP"]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    opts = {}
    if fmt == "TIFF":
        mode = draw(st.sampled_from(["1", "L", "P", "RGB", "RGBA", "CMYK",
                                     "I;16", "LA"]))
        opts["compression"] = draw(st.sampled_from(
            ["raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
             "packbits"]))
        if mode not in ("1", "P") and opts["compression"] in (
                "tiff_lzw", "tiff_adobe_deflate") and draw(st.booleans()):
            opts["tiffinfo"] = {317: 2}                 # predictor 2
    else:
        mode = draw(st.sampled_from(["RGB", "RGBA"]))
        opts["lossless"] = draw(st.booleans())
        opts["quality"] = draw(st.integers(0, 100))
        opts["method"] = draw(st.integers(0, 6))
        if not opts["lossless"]:
            opts["alpha_quality"] = draw(st.sampled_from([100, 50]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    return fmt, mode, h, w, opts, seed


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=_tiff_webp_files())
def test_random_tiff_webp_files_match_jax(scratch_dir, case):
    """Random small images that Pillow saves as TIFF (each mode, raw,
    LZW, Deflate or PackBits, with or without predictor 2) or WebP
    (lossless or lossy at any quality and method, RGB or RGBA) decode to
    JAX's pixels exactly; the file is named .tex."""
    fmt, mode, h, w, opts, seed = case
    rng = np.random.default_rng(seed)
    if mode == "I;16":
        im = PIL.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    else:
        rgb = make_textures.smooth_image(rng, h, w, 12.0)
        im = PIL.fromarray(rgb).convert(mode)
        if mode in ("RGBA", "LA"):
            im.putalpha(PIL.fromarray(rng.integers(0, 256, (h, w)).astype(
                np.uint8)))
    buf = io.BytesIO()
    im.save(buf, fmt, **opts)
    path = os.path.join(scratch_dir, "case.tex")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


# DDS kind -> (FourCC, DXGI format or None, bytes a 4x4 block)
_DDS_KINDS = {"dxt1": (b"DXT1", None, 8), "dxt3": (b"DXT3", None, 16),
              "dxt5": (b"DXT5", None, 16), "ati1": (b"ATI1", None, 8),
              "ati2": (b"ATI2", None, 16), "bc5s": (b"BC5S", None, 16),
              "bc6h_uf16": (b"DX10", 95, 16), "bc6h_sf16": (b"DX10", 96, 16),
              "bc7": (b"DX10", 98, 16)}


def _random_mask(rng) -> int:
    """A run of set bits anywhere in 32, none, or random bits."""
    pick = rng.integers(0, 8)
    if pick == 0:
        return 0
    if pick == 1:
        return int(rng.integers(0, 2 ** 32))
    lo = int(rng.integers(0, 32))
    return ((1 << int(rng.integers(1, 33 - lo))) - 1) << lo


@pytest.mark.parametrize("kind", [*_DDS_KINDS, "rgb_masks"])
def test_random_dds_files_match_jax(tmp_path, kind):
    """Seeded random DDS files decode to JAX's pixels exactly: random
    block bytes at random sizes up to 64x64 for every block-compressed
    kind (every BC6H and BC7 mode among them), and for uncompressed RGB
    random masks, bit counts (8 to 48) and sizes, some bodies cut short
    (Pillow reads the missing pixels as 0)."""
    rng = np.random.default_rng(sorted([*_DDS_KINDS, "rgb_masks"]).index(
        kind) + 190)
    for case in range(6):
        h, w = (int(x) for x in rng.integers(1, 65, 2))
        if kind == "rgb_masks":
            bits = int(rng.choice([8, 16, 24, 32, 48]))
            masks = [_random_mask(rng) for _ in range(4)]
            n = max(0, h * w * (bits // 8) - int(rng.integers(0, 3)) * 5)
            data = make_textures.dds_file(
                w, h, rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                pfflags=make_textures.DDS_RGB | int(rng.integers(0, 2)),
                bitcount=bits, masks=masks)
        else:
            fourcc, dxgi, size = _DDS_KINDS[kind]
            n = -(-h // 4) * -(-w // 4) * size
            data = make_textures.dds_file(
                w, h, rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                fourcc=fourcc, dxgi=dxgi)
        path = str(tmp_path / f"{case}.tex")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(_port_u8(path), _jax_u8(path),
                                      err_msg=f"{kind} case {case}")
