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
    forms, the RGB masks, the palette, crops and surfaces past the first),
    and TIFF's JPEG (each photometric and YCbCr subsampling, tiles,
    restarts, no tables), CCITT (RLE, Group 3 1D and 2D with fill bits,
    Group 4, tiles, wide rows, rows without EOLs, damaged rows), LZMA and
    ZSTD (each layout, a frame of RLE literals) and YCbCr through the RGBA
    path (1x1 to 4x4 and libtiff's quirks), and the JPEG variants Pillow
    does not write (each whole sampling ratio, CMYK and YCCK, arithmetic
    coding, unrefined scans under both codings, lossless at each
    predictor, the 256x256 arithmetic YCCK 4:4:0 crop of the texels);
    the set stays under 1 MB with
    the 1024x1024 progressive JPEG, its texels as a 1024x1024 lossy WebP,
    their lossless crop and a 1024x1024 tiled JPEG-in-TIFF in it."""
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
    codecs = {f"tiff_jpeg_{k}.tif" for k in (
        "grey", "rgb", "cmyk", "ycbcr11", "ycbcr21", "ycbcr22", "grey_tiles",
        "rgb_tiles", "ycbcr22_tiles", "ycbcr22_be", "ycbcr22_restart",
        "ycbcr22_no_tables", "ycbcr22_last_strip_full",
        "ycbcr21_no_subsampling_tag", "rgb_fill_order2",
        "ycbcr21_restart3_tiles")}
    codecs |= {f"tiff_bilevel_{k}.tif" for k in (
        "rle", "group3", "group3_2d", "group3_fill", "group3_2d_fill",
        "group4", "group4_min_is_white", "group4_tiles", "group3_2d_tiles",
        "group4_be", "rle_fill_order2", "group3_2d_fill_order2",
        "group4_fill_order2", "wide_group3", "wide_group4", "group4_strips",
        "group3_no_eol", "group3_damaged", "group3_2d_damaged",
        "rle_damaged")}
    codecs |= {f"tiff_{k}_{c}.tif" for c in ("lzma", "zstd") for k in (
        "grey8", "rgb", "rgba", "grey16", "float", "cmyk", "bilevel",
        "rgb_tiles", "rgb_planar", "grey16_be")}
    codecs |= {f"tiff_{k}_{c}_{p}.tif" for c in ("lzma", "zstd") for k, p in (
        ("rgb", "predictor2"), ("grey16_be", "predictor2"),
        ("float", "predictor3"))}
    codecs |= {f"tiff_ycbcr{k}_lzw.tif" for k in (
        "11", "12", "21", "22", "41", "42", "44")}
    codecs |= {f"tiff_ycbcr22_{c}.tif" for c in ("deflate", "packbits",
                                                  "lzma", "zstd")}
    codecs |= {f"tiff_pillow_{m}_{c}.tif" for m in ("1", "l", "rgb", "i16",
                                                     "ycbcr")
               for c in ("lzma", "zstd")}
    codecs |= {"tiff_ycbcr22_tiles.tif", "tiff_ycbcr44_tiles.tif",
               "tiff_ycbcr44_strips5.tif", "tiff_ycbcr11_planar.tif",
               "tiff_ycbcr22_predictor2.tif", "tiff_ycbcr21_predictor2.tif",
               "tiff_ycbcr22_orientation6.tif",
               "tiff_ycbcr21_bt709_studio.tif", "tiff_ycbcr42_be.tif",
               "tiff_grey8_zstd_rle_literals.tif",
               "tiff_pillow_ycbcr_jpeg.tif", "tiff_pillow_1_group4.tif",
               make_textures.TIFF_JPEG_BIG}
    assert codecs <= names, sorted(codecs - names)
    variants = {f"jpeg_sampling_{k}.jpg" for k in make_textures.SAMPLINGS}
    variants |= {f"jpeg_{k}.jpg" for k in (
        "sampling_440_narrow", "sampling_422_narrow",
        "sampling_adobe_rgb_440", "sampling_progressive_411", "cmyk_adobe",
        "cmyk_no_adobe", "cmyk_progressive", "cmyk_pillow", "ycck",
        "ycck_420", "arith_sequential", "arith_progressive",
        "arith_restart", "arith_dac", "arith_grey",
        "arith_progressive_restart_dac", "smooth_grey_dc_only",
        "lossless_grey_pt3", "lossless_rgb_pt2", "lossless_cmyk",
        "lossless_restart")}
    variants |= {f"jpeg_{c}smooth_{k}.jpg" for c in ("", "arith_")
                 for k in make_textures.SMOOTH_SCANS}
    variants |= {f"jpeg_lossless_p{k}.jpg" for k in range(1, 8)}
    variants.add(make_textures.JPEG_CROP_NAME)
    assert variants <= names, sorted(variants - names)
    shapes = {f["name"]: f["shape"] for f in MANIFEST["files"]}
    assert shapes[make_textures.JPEG_CROP_NAME] == [256, 256, 3]
    assert shapes[make_textures.TIFF_JPEG_BIG] == [1024, 1024, 3]
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
    ("arithmetic", lambda: make_textures.jpeg_refused("arithmetic_64k"),
     r"arithmetic-coded JPEG \(SOF9\)"),
    ("lossless", lambda: make_textures.jpeg_refused("lossless_ycc"),
     r"lossless JPEG"),
    ("12-bit", lambda: _jpeg_with(_set(4, 12)), r"12-bit JPEG"),
    ("cmyk", lambda: make_textures.jpeg_refused("cmyk_mcu"), r"CMYK"),
    ("440", lambda: make_textures.jpeg_refused("440_mcu"), r"4:4:0"),
    ("411", lambda: make_textures.jpeg_refused("411_mcu"), r"4:1:1"),
    ("tiff", lambda: make_textures.tiff_file(
        np.zeros((2, 2, 1), np.uint8), 8, 1, compression=4,
        raw_strips=[b"\x80"]), r"TIFF with CCITT Group 4 compression"),
    ("webp", lambda: make_textures.jpeg_tiff(
        np.zeros((16, 16, 3), np.uint8), 6, subsampling=2).replace(
        struct.pack("<HHIHH", 530, 3, 2, 2, 2),
        struct.pack("<HHIHH", 530, 3, 2, 1, 1)),
     r"TIFF with JPEG compression"),
    ("tiff_ycbcr", lambda: make_textures.ycbcr_tiff(
        np.zeros((4, 6, 3), np.uint8), 3, 1, 5),
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
    (ROADMAP queue 6 lists them in order), whatever the file's name, and
    so do files that Pillow refuses too: JPEGs of each case the port read
    none of before (arithmetic: a SOF9 scan past Pillow's first 64 KB
    block; lossless: lossless YCbCr; 12-bit; cmyk, 440 and 411: MCUs of
    more than 10 blocks at those samplings; tests/test_torch_jpeg_variants.py
    holds Pillow to refusing each), a Group 4 TIFF of 8-bit samples
    (libtiff's CCITT decoders take 1-bit ones), a JPEG-in-TIFF whose
    stream's sampling is not its YCbCrSubsampling, a YCbCr TIFF
    subsampled 3x1, a TIFF whose LZMA strip is no .xz stream, CIE L*a*b*
    (not ported), and a big-endian BigTIFF, which Pillow reads as a
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
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.load_image(str(path))


def test_truncated_qoi_header_raises_naming_qoi(tmp_path):
    """The QOI header test_not_a_png_raises once fed: QOI now decodes,
    and this header (a height read from the text after it, past Pillow's
    pixel limit) raises a QOI error, as Pillow refuses it."""
    path = tmp_path / "n.png"
    path.write_bytes(b"qoif\x00\x00\x00\x04 a QOI header")
    with pytest.raises(ValueError, match="QOI"):
        image_io.load_image(str(path))
    with pytest.raises(Exception):
        jax_image_io.load_image(str(path))


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
    ("tiff_jpeg_ycbcr22.tif", "cut", "TIFF with JPEG compression"),
    ("tiff_pillow_rgb_jpeg.tif", "cut",
     "TIFF with JPEG compression.*corrupt JPEG"),
    # a big-endian classic file under BigTIFF's version, which libtiff
    # reads as a BigTIFF (Pillow as classic)
    ("tiff_grey16_be_lzma.tif", (b"\x00\x2a", b"\x00\x2b"),
     "TIFF with LZMA compression.*BigTIFF"),
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


@st.composite
def _tiff_codec_files(draw):
    comp = draw(st.sampled_from(["jpeg", "tiff_ccitt", "group3", "group4",
                                 "lzma", "zstd"]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    info = {}
    if comp == "jpeg":
        mode = draw(st.sampled_from(["L", "RGB", "CMYK", "YCbCr"]))
        info[278] = draw(st.sampled_from([8, 16, 24, h]))
        opts = dict(quality=draw(st.integers(5, 100)))
    elif comp in ("tiff_ccitt", "group3", "group4"):
        mode, opts = "1", {}
        if comp == "group3":
            info[292] = draw(st.sampled_from([0, 1, 4, 5]))
        info[262] = draw(st.sampled_from([0, 1]))
        info[266] = draw(st.sampled_from([1, 2]))
        info[278] = draw(st.integers(1, h))
    else:
        mode = draw(st.sampled_from(["1", "L", "P", "RGB", "RGBA", "CMYK",
                                     "I;16", "LA", "YCbCr"]))
        opts = {}
        if mode not in ("1", "P") and draw(st.booleans()):
            info[317] = 2
        info[278] = draw(st.integers(1, h))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    return comp, mode, h, w, info, opts, seed


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=_tiff_codec_files())
def test_random_tiff_codec_files_match_jax(scratch_dir, case):
    """Random small images that Pillow saves as JPEG-in-TIFF (grey, RGB,
    CMYK or YCbCr, any quality, strips of 8 to 24 rows), CCITT RLE, Group
    3 (1D or 2D, with or without fill bits) or Group 4 (either
    photometric, either fill order, any strip height), LZMA or ZSTD (each
    mode, with or without predictor 2) decode to JAX's pixels exactly;
    the file is named .tex."""
    comp, mode, h, w, info, opts, seed = case
    rng = np.random.default_rng(seed)
    if mode == "I;16":
        im = PIL.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    elif mode == "1":
        im = PIL.fromarray(np.repeat(rng.random((h, w)) < 0.4, 1 + seed % 5,
                                     axis=1)[:, :w])
    else:
        im = PIL.fromarray(make_textures.smooth_image(rng, h, w, 12.0)) \
            .convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=comp, tiffinfo=info, **opts)
    path = os.path.join(scratch_dir, "case.tex")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


def _seeded_writer_files():
    """Seeded random files of make_textures' JPEG-in-TIFF and YCbCr
    writers: (name, bytes), each layout and subsampling at random sizes."""
    rng = np.random.default_rng(2020)
    out = []
    for k in range(12):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        img = make_textures.smooth_image(rng, h, w, 18.0)
        tiled = bool(k % 3 == 0)
        rows = int(rng.choice([8, 16, 32])) if not tiled else None
        sub = int(rng.integers(0, 3))
        photo = int(rng.choice([1, 2, 5, 6]))
        src = {1: img[..., :1], 2: img, 5: np.concatenate(
            [img, img[..., :1]], -1), 6: img}[photo]
        out.append((f"jpeg p{photo} s{sub} {h}x{w}", make_textures.jpeg_tiff(
            src, photo, rows_per_strip=rows if photo != 6 or sub < 2 or
            rows is None else max(16, rows), tile=(16, 16) if tiled else None,
            subsampling=sub if photo == 6 else 0,
            quality=int(rng.integers(20, 100)),
            restart=int(rng.choice([0, 1, 2])),
            order=str(rng.choice(["<", ">"])))))
        hs, vs = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                  (4, 4)][k % 7]
        comp = int(rng.choice([5, 8, 32773, 34925, 50000]))
        out.append((f"ycbcr {hs}x{vs} {comp} {h}x{w}", make_textures
                    .ycbcr_tiff(img, hs, vs, comp, tile=(16, 16) if tiled
                                else None, rows_per_strip=None if tiled else
                                int(rng.integers(1, h + 1)),
                                order=str(rng.choice(["<", ">"])))))
    return out


@pytest.mark.parametrize("name,data", _seeded_writer_files(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_seeded_jpeg_and_ycbcr_tiffs_match_jax(tmp_path, name, data):
    """Seeded random JPEG-in-TIFF files (photometric 1, 2, 5 or 6 at 1x1,
    2x1 or 2x2, strips or tiles, any quality, restart markers, either byte
    order) and YCbCr files of libtiff's RGBA path (1x1 to 4x4, each
    compression, strips of any height or tiles, either byte order) decode
    to JAX's pixels exactly."""
    path = str(tmp_path / "case.tex")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path), name)


def _zstd_stream_files():
    """Test-time ZSTD TIFFs whose frames reach the modes a small fixture
    does not: [(name, bytes)] of 8-bit grey images of 300 to 600 KB."""
    rng = np.random.default_rng(2021)
    pre = rng.integers(0, 256, 2000, dtype=np.uint8)
    starts, lens = rng.integers(0, 1900, 8000), rng.integers(20, 60, 8000)
    slices = np.frombuffer((pre.tobytes() + b"".join(
        b"\xff" + pre[a:a + n].tobytes() for a, n in zip(starts, lens)))
        [:300000], np.uint8)
    rng = np.random.default_rng(2021)
    gap = np.frombuffer((b"\xff" + bytes(20)) * 15000, np.uint8)
    blocks = np.repeat(rng.integers(0, 8, 60000).astype(np.uint8), 5)
    noise = rng.integers(0, 256, 5000, dtype=np.uint8)
    flat = np.zeros(300000, np.uint8)
    out = []
    import zstandard

    for name, data, level in (("gap", gap, 1), ("blocks", blocks, 10),
                              ("noise", noise, 3), ("flat", flat, 3),
                              ("slices", slices, 9)):
        w = 500
        img = np.resize(data, (len(data) // w, w))
        frame = zstandard.ZstdCompressor(level=level).compress(img.tobytes())
        out.append((name, frame, make_textures.tiff_file(
            img[..., None], 8, 1, compression=50000, raw_strips=[frame])))
    return out


def test_zstd_and_fax_coverage(tmp_path):
    """The fixtures and the test-time files reach every ZSTD literals type
    (raw, RLE, compressed and treeless, in one and four streams), every
    sequence mode of the literal length, offset and match length codes
    (predefined, RLE, FSE, repeat), raw, RLE and compressed blocks, blocks
    without sequences and both forms of Huffman weights; and Group 3 rows
    of both codings, with repairs of damaged rows. The test-time files
    decode to JAX's pixels."""
    from cge_tpu_torch.scene import tiff

    zstd = np.zeros(25, np.int64)
    fax = np.zeros(6, np.int64)
    for entry in MANIFEST["files"]:
        with open(os.path.join(FIXTURES, entry["name"]), "rb") as f:
            data = f.read()
        if not entry["name"].endswith(".tif"):
            continue
        _, order, tags = tiff._ifd(data)
        comp = tags.get(259, 1)
        offsets, counts = tiff._list(tags[273 if 273 in tags else 324]), \
            tiff._list(tags[279 if 279 in tags else 325])
        if comp == 50000:
            for off, n in zip(offsets, counts):
                st_ = np.zeros(25, np.int64)
                try:
                    native.zstd(data[off:off + n], 1 << 20, st_)
                except ValueError:
                    pass             # more asked for than the strip holds
                zstd += st_
        if comp == 3 and 322 not in tags:
            ev = np.zeros(6, np.int64)
            fill = tags.get(266, 1)
            chunks = [data[off:off + n] for off, n in zip(offsets, counts)]
            if fill == 2:
                chunks = [tiff._REV[np.frombuffer(c, np.uint8)].tobytes()
                          for c in chunks]
            h, w = tags[257], tags[256]
            rps = tags.get(278, h)
            native.fax(chunks, 3, tiff._list(tags.get(292, 0))[0], w,
                       [min(rps, h - i * rps) for i in range(len(chunks))],
                       ev)
            fax += ev
    for name, frame, data in _zstd_stream_files():
        st_ = np.zeros(25, np.int64)
        path = str(tmp_path / f"{name}.tif")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(_port_u8(path), _jax_u8(path), name)
        _, _, tags = tiff._ifd(data)
        native.zstd(frame, tags[256] * tags[257], st_)
        zstd += st_
    kinds = ["literals raw", "literals RLE", "Huffman 1 stream",
             "Huffman 4 streams", "treeless 1 stream", "treeless 4 streams"]
    kinds += [f"{c} {m}" for c in ("literal lengths", "offsets",
                                   "match lengths")
              for m in ("predefined", "RLE", "FSE", "repeat")]
    kinds += ["no sequences", "skippable", "FSE weights", "direct weights",
              "raw block", "RLE block", "compressed block"]
    missing = [k for k, n in zip(kinds, zstd) if n == 0 and k != "skippable"]
    assert not missing, missing
    assert fax[4] > 0 and fax[5] > 0, fax          # 1D and 2D rows
    assert fax[0] > 0 and fax[1] > 0, fax          # repaired rows


def _zstd_tiff(frame: bytes, n: int = 64) -> bytes:
    return make_textures.tiff_file(np.zeros((8, n // 8, 1), np.uint8), 8, 1,
                                   compression=50000, raw_strips=[frame])


def _zstd_frame(data: bytes = bytes(range(64))) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor(level=3).compress(data)


@pytest.mark.parametrize("kind,make", [
    ("skippable_first", lambda: struct.pack("<II", 0x184D2A50, 4) + b"abcd"
     + _zstd_frame()),
    ("dictionary", lambda: _zstd_frame()[:4] + bytes((0x01,)) + b"\x07"
     + _zstd_frame()[5:]),
    ("reserved_bit", lambda: _zstd_frame()[:4] + bytes(
        (_zstd_frame()[4] | 8,)) + _zstd_frame()[5:]),
    ("not_zstd", lambda: b"\x28\xb5\x2f\xfe" + _zstd_frame()[4:]),
    ("cut", lambda: _zstd_frame(bytes(range(64)) * 4)[:-9]),
    ("frame_too_short", lambda: _zstd_frame(bytes(range(40)))),
    ("two_frames", lambda: _zstd_frame(bytes(32)) + _zstd_frame(bytes(32)))])
def test_zstd_frames_libzstd_refuses(tmp_path, kind, make):
    """ZSTD strips that libtiff's streaming loop refuses raise a ValueError
    naming the TIFF and ZSTD, and JAX's loader raises too: a skippable
    frame first (libzstd returns 0 after it, and the strip is empty), a
    frame naming a dictionary, a reserved header bit, a wrong magic
    number, a cut frame, a frame shorter than its strip, and two frames
    (only the first is read)."""
    path = str(tmp_path / "texture.tif")
    with open(path, "wb") as f:
        f.write(_zstd_tiff(make()))
    with pytest.raises(ValueError, match="TIFF with ZSTD.*ZSTD") as e:
        mesh_io.load_image(path)
    assert path in str(e.value)
    with pytest.raises(Exception):
        jax_image_io.load_image(path)


def _damaged_fax_files():
    """Seeded CCITT files of Pillow's with bits flipped, strips cut or
    bytes appended: [(name, bytes)]."""
    rng = np.random.default_rng(2022)
    out = []
    for case in range(45):
        h, w = int(rng.integers(2, 30)), int(rng.integers(2, 70))
        a = np.repeat(rng.random((h, w)) < 0.4, 3, axis=1)[:, :w]
        comp = ["tiff_ccitt", "group3", "group4"][case % 3]
        info = {278: int(rng.integers(1, h + 1))}
        if comp == "group3":
            info[292] = int(rng.choice([0, 1, 4, 5]))
        data = make_textures._pillow(PIL.fromarray(a), "TIFF",
                                     compression=comp, tiffinfo=info)
        t = PIL.open(io.BytesIO(data))
        chunks = [bytearray(data[o:o + n]) for o, n in zip(
            t.tag_v2[273], t.tag_v2[279])]
        k = int(rng.integers(0, len(chunks)))
        how = ["flip", "cut", "append"][case // 3 % 3]
        if how == "flip":
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(0, len(chunks[k])))
                chunks[k][j] ^= 1 << int(rng.integers(0, 8))
        elif how == "cut":
            chunks[k] = chunks[k][:max(1, int(rng.integers(0, len(
                chunks[k]))))]
        else:
            chunks[k] += rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
        num = {"tiff_ccitt": 2, "group3": 3, "group4": 4}[comp]
        extra = [(292, 4, [info[292]])] if 292 in info else []
        out.append((f"{comp} {how} {h}x{w}", make_textures.tiff_file(
            a[..., None].astype(np.uint8), 1, 1, compression=num,
            rows_per_strip=info[278], raw_strips=[bytes(c) for c in chunks],
            extra_tags=extra)))
    return out


@pytest.mark.parametrize("name,data", _damaged_fax_files(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_damaged_fax_files_match_jax(tmp_path, name, data):
    """Damaged CCITT files decode as libtiff repairs them for Pillow (rows
    cut or padded to their width, rows after a lost EOL searched for, no-
    EOL mode where a strip has none), or raise where Pillow raises; a
    Group 4 strip that ends before its last row, for which Pillow returns
    rows no decoder wrote, raises in the port."""
    path = str(tmp_path / "texture.tif")
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = _jax_u8(path)
    except Exception:
        ref = None
    try:
        port = _port_u8(path)
    except ValueError as e:
        assert path in str(e)
        assert ref is None or "Group 4 data ends" in str(e), (name, str(e))
        return
    assert ref is not None, name
    np.testing.assert_array_equal(port, ref, name)


def _damaged_ycbcr_files():
    """Seeded YCbCr files of libtiff's RGBA path (each subsampling and
    compression) with one strip cut short, bytes flipped or bytes
    appended: [(name, bytes)]."""
    rng = np.random.default_rng(2023)
    out = []
    for case in range(35):
        h, w = (int(v) for v in rng.integers(4, 30, 2))
        px = make_textures.smooth_image(rng, h, w, 20.0)
        hs, vs = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                  (4, 4)][case % 7]
        comp = [5, 8, 32773, 34925, 50000][case % 5]
        rps = int(rng.integers(1, h + 1))
        raws = [bytearray(make_textures.compress_chunk(
            make_textures.ycbcr_units(px[y:y + rps], hs, vs).tobytes(),
            comp)) for y in range(0, h, rps)]
        k = int(rng.integers(0, len(raws)))
        how = ["cut", "flip", "append"][case % 3]
        if how == "cut":
            raws[k] = raws[k][:int(rng.integers(1, len(raws[k]) + 1))]
        elif how == "flip":
            for _ in range(2):
                j = int(rng.integers(0, len(raws[k])))
                raws[k][j] ^= 1 << int(rng.integers(0, 8))
        else:
            raws[k] += rng.integers(0, 256, 5, dtype=np.uint8).tobytes()
        out.append((f"ycbcr {hs}x{vs} {comp} {how} {h}x{w}",
                    make_textures.tiff_file(
                        np.zeros((h, w, 3), np.uint8), 8, 6, compression=comp,
                        rows_per_strip=rps,
                        raw_strips=[bytes(r) for r in raws],
                        extra_tags=[(530, 3, (hs, vs))])))
    return out


@pytest.mark.parametrize("name,data", _damaged_ycbcr_files(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_damaged_ycbcr_files_match_jax(tmp_path, name, data):
    """YCbCr strips of the RGBA path that fail to decode (LZW, Deflate,
    PackBits and LZMA cut short or with bytes flipped) read as Pillow
    reads them: libtiff hands over what it decoded before the failure and
    zeros after, and Pillow goes on; where Pillow raises, so does the port,
    and so it does for a ZSTD strip that fails (what libzstd leaves in its
    output then is its internals')."""
    path = str(tmp_path / "texture.tif")
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = _jax_u8(path)
    except Exception:
        ref = None
    if ref is None:
        with pytest.raises(ValueError, match=path):
            _port_u8(path)
        return
    try:
        port = _port_u8(path)
    except ValueError as e:
        assert " 50000 " in name and "ZSTD" in str(e), (name, str(e))
        return
    np.testing.assert_array_equal(port, ref, name)


def _jpeg_streams(photo, rows=16, **kw):
    """(strips, tables) of a make_textures JPEG-in-TIFF of a seeded image
    (photometric 1, 2, 5 or 6) in strips of `rows` rows."""
    img = make_textures.smooth_image(np.random.default_rng(2024), 21, 19,
                                     14.0)
    src = {1: img[..., :1], 2: img, 5: np.concatenate(
        [img, img[..., :1]], -1), 6: img}[photo]
    data = make_textures.jpeg_tiff(src, photo, rows_per_strip=rows, **kw)
    t = PIL.open(io.BytesIO(data))
    return [data[o:o + n] for o, n in zip(t.tag_v2[273], t.tag_v2[279])], \
        t.tag_v2[347]


def _jpeg_tiff_of(streams, photo, spp, rows=16, extra=()):
    strips, tables = streams
    return make_textures.tiff_file(
        np.zeros((21, 19, spp), np.uint8), 8, photo, compression=7,
        rows_per_strip=rows, raw_strips=strips,
        extra_tags=[(347, 7, tables), *extra])


@pytest.mark.parametrize("kind,make,words", [
    ("jpeg_p1_three_components", lambda: _jpeg_tiff_of(
        _jpeg_streams(2), 1, 1), "JPEG.*component count 3"),
    ("jpeg_p2_subsampled", lambda: _jpeg_tiff_of(
        _jpeg_streams(6, subsampling=2), 2, 3), "JPEG sampling factors 2,2"),
    ("jpeg_p5_three_components", lambda: _jpeg_tiff_of(
        _jpeg_streams(2), 5, 4), "JPEG.*component count 3"),
    ("jpeg_p6_stream_past_its_strip", lambda: _jpeg_tiff_of(
        (_jpeg_streams(6, rows=32, subsampling=2)[0]
         + _jpeg_streams(6, subsampling=2)[0][1:],
         _jpeg_streams(6, subsampling=2)[1]), 6, 3,
        extra=[(530, 3, (2, 2))]), "JPEG exceeds its 19x16 strip"),
    ("jpeg_p6_no_tables", lambda: make_textures.jpeg_tiff(
        np.zeros((16, 16, 3), np.uint8), 6, subsampling=2).replace(
        struct.pack("<HH", 347, 7), struct.pack("<HH", 32998, 7)),
     "quantisation table is undefined"),
    ("group3_8bit", lambda: make_textures.tiff_file(
        np.zeros((2, 2, 1), np.uint8), 8, 1, compression=3,
        raw_strips=[b"\x00\x01\x80"]), "CCITT decoders take 1-bit"),
    ("group4_first_row", lambda: make_textures.tiff_file(
        np.zeros((2, 8, 1), np.uint8), 1, 1, compression=4,
        raw_strips=[b"\x00"]), "CCITT data ends inside row 0"),
    ("rle_cut", lambda: make_textures.tiff_file(
        np.zeros((4, 8, 1), np.uint8), 1, 1, compression=2,
        raw_strips=[b"\x35"]), "CCITT data ends inside row 1"),
    ("group3_2d_fill_cut", lambda: make_textures.tiff_file(
        np.zeros((4, 8, 1), np.uint8), 1, 1, compression=3,
        raw_strips=[b"\x00\x18"], extra_tags=[(292, 4, [5])]),
     "CCITT data ends inside row 3"),
    ("ycbcr22_planar", lambda: make_textures.ycbcr_tiff(
        np.zeros((6, 5, 3), np.uint8), 2, 2, 5, planar=2),
     "no RGBA conversion of YCbCr subsampled 2,2"),
    ("ycbcr_16bit", lambda: make_textures.tiff_file(
        np.zeros((4, 4, 3), np.uint16), 16, 6, compression=5),
     "YCbCr of these samples")])
def test_tiff_codec_refusals_match_pillow(tmp_path, kind, make, words):
    """Where Pillow (through libtiff) refuses a JPEG-in-TIFF at each
    photometric (a stream of the wrong component count or sampling, one
    taller than its strip, tables missing), a CCITT file (8-bit samples,
    data that ends inside a row of RLE, Group 3 2D with fill bits and the
    first row of Group 4) or a YCbCr file (subsampled in planes, 16-bit),
    the port raises a ValueError naming the file and the case."""
    path = str(tmp_path / "texture.tif")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(ValueError, match=words) as e:
        mesh_io.load_image(path)
    assert path in str(e.value)
    with pytest.raises(Exception):
        jax_image_io.load_image(path)
