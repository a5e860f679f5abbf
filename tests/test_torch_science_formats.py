"""The port's readers of FITS, McIdas, SPIDER, IFUNC IM, IM Tools and
IPTC/NAA files (cge_tpu_torch/scene/fits.py, mcidas.py, spider.py, im.py,
imt.py, iptc.py; IM's bit decoder in native/cge_raster.cpp) against Pillow
12, which the JAX package's loader uses: every fixture of
tests/torch_textures/science/ against JAX's `load_image` and its
manifest's hash (or, for the files JAX refuses, a refusal), each cut at
five lengths; random files of Pillow's own IM and SPIDER writers
(hypothesis); hand-made files of each quirk of the plugins, their raw
layouts and the bit decoder (make_textures.fits_file, mcidas_file,
spider_file, im_file, imt_file, iptc_file); the native bit loop against a
Python twin; what escapes Image.open as refusals; and the place of the four
plugins without a test of the first bytes (IM, IMT, IPTC, SPIDER) in
Image.open's order. Each refusal is a ValueError that names the file and
the format. Pixels must be equal exactly."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import im, image_io, mesh_io
from jax_references import make_textures as mt

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_textures", "science")
with open(os.path.join(FOLDER, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
FORMATS = ("fits", "mcidas", "spider", "im", "imt", "iptc")
# Pillow's format names -> the port's
PILLOW_NAMES = {"FITS": "FITS", "MCIDAS": "McIdas", "SPIDER": "SPIDER",
                "IM": "IM", "IMT": "IMT", "IPTC": "IPTC"}


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="t.tex", fmt=None):
    """The port's pixels equal JAX's; where JAX's loader raises, the port
    raises a ValueError naming the file and the format (fmt, or the one
    format_of names). JAX's pixels, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = _jax_u8(path)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match=fmt or image_io.format_of(
                data)) as e:
            mesh_io.load_image(path)
        assert path in str(e.value)
        return None
    np.testing.assert_array_equal(_port_u8(path), want)
    return want


def _pillow_format(data: bytes):
    """The plugin Image.open settles on, or None where none opens it."""
    try:
        with PIL.open(io.BytesIO(data)) as img:
            return img.format
    except Exception:
        return None


# -------------------------------------------------------------- fixtures

def test_fixtures_cover_every_kind():
    """The folder holds each format and a refusal of each, under 512 KiB;
    the chip path's IPTC crop is at most 256x256."""
    kinds = {e["kind"] for e in MANIFEST}
    assert kinds == set(FORMATS) | {f + "_refused" for f in FORMATS}
    assert sum(e["bytes"] for e in MANIFEST) < 512 << 10
    for e in MANIFEST:
        assert (e["sha256"] is None) == e["kind"].endswith("_refused")
    chip = next(e for e in MANIFEST if e["name"] == mt.SCIENCE_CHIP)
    assert chip["shape"] == [mt.SCIENCE_CROP, mt.SCIENCE_CROP, 3]
    assert mt.SCIENCE_CROP <= 256


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_matches_jax_and_its_hash(tmp_path, name):
    """Each fixture decodes to JAX's pixels, whose hash its manifest holds
    (the hash chip_smoke.py checks on the card's machine); a refused one
    raises in both, the port's error naming the file and the format."""
    entry = next(e for e in MANIFEST if e["name"] == name)
    path = os.path.join(FOLDER, name)
    data = open(path, "rb").read()
    if entry["sha256"] is None:
        with pytest.raises(Exception):
            _jax_u8(path)
        with pytest.raises(ValueError, match=image_io.format_of(data)) as e:
            mesh_io.load_image(path)
        assert path in str(e.value)
        return
    got = _port_u8(path)
    np.testing.assert_array_equal(got, _jax_u8(path))
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    assert image_io.format_of(data) == PILLOW_NAMES[_pillow_format(data)]


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_cut_short_matches_jax(tmp_path, name):
    """Each fixture cut at four lengths, and one byte short: JAX's pixels,
    or both refuse."""
    data = open(os.path.join(FOLDER, name), "rb").read()
    for k in (1, 2, 3, 4):
        _same_as_jax(tmp_path, data[:len(data) * k // 5], f"cut{k}.tex")
    _same_as_jax(tmp_path, data[:-1], "cut_last.tex")


# ------------------------------------------------ Pillow's own writers

# the modes of Pillow 12's ImImagePlugin.SAVE (test_im_save_modes holds
# this list to it; importing the plugin here, before Image.init, would
# change the order Image.open tries the plugins in)
IM_SAVE = ["1", "CMYK", "F", "I", "I;16", "I;16B", "I;16L", "L", "LA", "P",
           "PA", "RGB", "RGBA", "RGBX", "YCbCr"]


def test_im_save_modes():
    PIL.init()
    from PIL import ImImagePlugin

    assert sorted(ImImagePlugin.SAVE) == IM_SAVE


@st.composite
def _pillow_saved(draw):
    fmt = draw(st.sampled_from(["IM", "SPIDER"]))
    h, w = draw(st.integers(1, 24)), draw(st.integers(1, 24))
    mode = draw(st.sampled_from(IM_SAVE if fmt == "IM"
                                else ["L", "F", "RGB", "I"]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    if mode == "F":
        img = PIL.fromarray(rng.uniform(-50, 320, (h, w)).astype(
            np.float32), "F")
    elif mode in ("I", "I;16", "I;16L", "I;16B"):
        img = PIL.fromarray(rng.integers(0, 600, (h, w)).astype(np.int32),
                            "I").convert(mode)
    else:
        rgb = PIL.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        img = rgb.convert(mode) if mode != "P" else rgb.convert(
            "P", palette=PIL.Palette.ADAPTIVE,
            colors=int(rng.integers(2, 256)))
    b = io.BytesIO()
    img.save(b, fmt)
    return fmt, mode, b.getvalue()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_pillow_saved())
def test_pillow_written_files_match_jax(tmp_path_factory, case):
    """Random IM files of every mode Pillow's IM writer takes (its SAVE
    table) and SPIDER files of its writer (any mode, saved as float32): the
    port's pixels are JAX's."""
    fmt, mode, data = case
    assert image_io.format_of(data) == fmt
    assert _same_as_jax(tmp_path_factory.mktemp("s"), data) is not None


# ------------------------------------------------------------------ FITS

def test_fits_reads_big_endian_samples_little_endian(tmp_path):
    """Pillow reads FITS samples in its own raw layouts, little-endian: 300
    at BITPIX 16 reads as 11265 (saturated to 255), 1.0 at BITPIX -32 as
    4.6e-41 (0), 1 at BITPIX 32 as 16777216 (255); rows from the bottom."""
    v16 = np.array([[300, 1], [256, 2]])
    got = _same_as_jax(tmp_path, mt.fits_file(v16, 16))
    assert got[..., 0].tolist() == [[255, 255], [1, 255]]
    f = np.array([[1.0, 0.0]], np.float32)
    assert _same_as_jax(tmp_path, mt.fits_file(f, -32))[..., 0].tolist() == \
        [[0, 0]]
    got = _same_as_jax(tmp_path, mt.fits_file(np.array([[1, 0]]), 32))
    assert got[..., 0].tolist() == [[255, 0]]
    rows = np.arange(12).reshape(3, 4)
    got = _same_as_jax(tmp_path, mt.fits_file(rows, 8))
    np.testing.assert_array_equal(got[..., 0], rows)   # FITS: bottom first


def test_fits_bitpix_minus_64_reads_float32_pairs(tmp_path):
    """BITPIX -64 is Pillow's F: each row NAXIS1 float32s of the doubles'
    bytes, little-endian, so the image holds the first half of the data."""
    v = np.array([[2.0, 3.0, 0.5, 7.0]])
    data = mt.fits_file(v, -64)
    got = _same_as_jax(tmp_path, data)
    first = np.frombuffer(v.astype(">f8").tobytes(), "<f4")[:4]
    np.testing.assert_array_equal(got[0, :, 0], np.trunc(np.clip(
        first, 0, 255)).astype(np.uint8))


@pytest.mark.parametrize("zbits,hw", [(8, (3, 4)), (16, (2, 5)),
                                      (32, (4, 2))])
def test_fits_gzip1_keeps_the_last_bytes_of_each_4(tmp_path, zbits, hw):
    """GZIP_1: of each pixel's 4 gunzipped bytes the last ZBITPIX / 8, in
    the mode's little-endian layout, rows from the bottom."""
    h, w = hw
    rng = np.random.default_rng(zbits)
    quads = rng.integers(0, 4, (h, w, 4)).astype(np.uint8)
    got = _same_as_jax(tmp_path, mt.fits_gzip_file(quads.tobytes(), w, h,
                                                   zbits, table=(8, 10)))
    keep = quads[::-1, :, 4 - zbits // 8:]
    v = np.ascontiguousarray(keep).view({8: "u1", 16: "<u2", 32: "<i4"}[
        zbits])[..., 0]
    np.testing.assert_array_equal(got[..., 0], np.clip(v, 0, 255))


@pytest.mark.parametrize("case,data,fmt", [
    ("first_card_not_simple_t", mt.fits_file(np.ones((2, 2)), 8).replace(
        b"                   T", b"                   F", 1), "FITS"),
    ("no_bitpix", mt.fits_file(np.ones((2, 2)), 8).replace(
        b"BITPIX", b"BITPIY", 1), "FITS"),
    ("bitpix_12", mt.fits_file(np.ones((2, 2)), 8).replace(
        mt.fits_card(b"BITPIX", b"8"), mt.fits_card(b"BITPIX", b"12")),
     "FITS"),
    ("naxis_0_only", mt.fits_hdu([mt.fits_card(b"SIMPLE", b"T"),
                                  mt.fits_card(b"BITPIX", b"8"),
                                  mt.fits_card(b"NAXIS", b"0")]) + b"x" * 90,
     "FITS"),
    ("header_never_ends", mt.fits_file(np.ones((2, 2)), 8)[:800], "FITS"),
    ("naxis1_zero", mt.fits_file(np.ones((2, 2)), 8, naxis=[
        mt.fits_card(b"NAXIS", b"2"), mt.fits_card(b"NAXIS1", b"0"),
        mt.fits_card(b"NAXIS2", b"2")]), "FITS"),
    ("value_with_slash_comment", mt.fits_file(np.ones((2, 3)), 8).replace(
        mt.fits_card(b"NAXIS1", b"3"), b"NAXIS1  = 3 / three columns".ljust(
            80)), "FITS"),
    ("data_unit_starts_xtension", mt.fits_file(np.zeros((3, 30)), 8)[:2880]
     + b"XTENSION" + bytes(82) + b"END".ljust(80) + bytes(2800), "FITS"),
    ("past_the_pixel_limit", mt.fits_file(np.ones((1, 1)), 8, naxis=[
        mt.fits_card(b"NAXIS", b"2"), mt.fits_card(b"NAXIS1", b"20000"),
        mt.fits_card(b"NAXIS2", b"20000")]), "FITS")])
def test_fits_cases(tmp_path, case, data, fmt):
    """FitsImagePlugin's header walk: SIMPLE = T first, the cards it needs
    (a missing one is its KeyError, not opened), a BITPIX of no mode, a
    unit of no image ("No image data" escapes), a header cut before END, an
    empty image, a '/' comment, a data unit whose first card reads as
    XTENSION (the walk goes on through it), the decompression-bomb limit."""
    _same_as_jax(tmp_path, data, fmt=fmt)


# ---------------------------------------------------------------- McIdas

def test_mcidas_prefix_and_stride(tmp_path):
    """Each line: w[15] prefix bytes, then the elements of w[14] bands, of
    which the first band's are read; the prefix of the first line is at
    w[34]."""
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (4, 5, 3))
    got = _same_as_jax(tmp_path, mt.mcidas_file(px, 1, prefix=7,
                                                offset=400))
    lines = px.reshape(4, -1)[:, :5]
    np.testing.assert_array_equal(got[..., 0], lines)


@pytest.mark.parametrize("case,data", [
    ("prefix_bytes", mt.mcidas_file(np.arange(6).reshape(2, 3), 1, prefix=2)),
    ("two_bytes_saturated", mt.mcidas_file(np.array([[1, 300, 255]]), 2)),
    ("four_bytes_signed", mt.mcidas_file(np.array([[2 ** 31 + 5, 7]]), 4)),
    ("element_size_3", mt.mcidas_file(np.ones((2, 2)), 1, words={11: 3})),
    ("empty", mt.mcidas_file(np.ones((2, 2)), 1, words={9: 0})),
    ("directory_cut", mt.mcidas_file(np.ones((2, 2)), 1)[:200]),
    ("negative_offset", mt.mcidas_file(np.ones((2, 2)), 1,
                                       words={34: -300})),
    ("stride_shorter_than_a_line_mapped", mt.mcidas_file(
        np.arange(12).reshape(3, 4), 1, words={14: 0, 15: 1})),
    ("stride_shorter_than_a_line_cut", mt.mcidas_file(
        np.arange(12).reshape(3, 4), 1, words={14: 0, 15: 1})[:260]),
    ("stride_0_two_bytes", mt.mcidas_file(np.arange(6).reshape(2, 3), 2,
                                          words={14: 0},
                                          tail=bytes(12))),
    ("stride_negative", mt.mcidas_file(np.arange(6).reshape(2, 3), 1,
                                       words={14: -1}, tail=bytes(3))),
    ("stride_past_a_c_int", mt.mcidas_file(np.arange(6).reshape(2, 3), 1,
                                           words={14: -2 ** 31 + 1})),
    ("last_line_padding_missing", mt.mcidas_file(
        np.arange(12).reshape(3, 2, 2), 1)[:-2]),
    ("four_bytes_stride_short", mt.mcidas_file(np.ones((2, 2)), 4,
                                               words={14: 0, 15: 1}))])
def test_mcidas_cases(tmp_path, case, data):
    """McIdasImagePlugin: the 00 x 7, 04 prefix, element sizes 1, 2 (I;16B)
    and 4 (big-endian I), an empty image or a cut directory not opened;
    Pillow's loader maps L and I;16B files that hold every line (lines
    overlap where the stride is short, follow one another where it is 0 or
    less, a stride past a C int escapes), else its raw decoder reads them
    (a short stride refused, the last line's padding not needed)."""
    _same_as_jax(tmp_path, data, fmt="McIdas")


# ---------------------------------------------------------------- SPIDER

@pytest.mark.parametrize("case,data,fmt", [
    ("big_endian", mt.spider_file(np.arange(6).reshape(2, 3) * 40.5),
     "SPIDER"),
    ("little_endian", mt.spider_file(np.arange(6).reshape(3, 2) * 50.25,
                                     big=False), "SPIDER"),
    ("clamped_and_truncated", mt.spider_file(np.array(
        [[-0.99, 254.6, 255.99, 1e9, -np.inf, np.inf]])), "SPIDER"),
    ("stack_first_image", mt.spider_header(3, 2, istack=1, maxim=1)
     + mt.spider_file(np.full((2, 3), 9.0)), "SPIDER"),
    ("stack_nan_count", mt.spider_header(3, 2, istack=1,
                                         maxim=float("nan"))
     + mt.spider_file(np.full((2, 3), 9.0)), "SPIDER"),
    ("image_within_a_stack", mt.spider_file(np.ones((2, 3)), imgnumber=2),
     "SPIDER"),
    ("inconsistent_stack", mt.spider_file(np.ones((2, 3)), istack=-1),
     "unknown"),
    ("istack_nan", mt.spider_file(np.ones((2, 3)), istack=float("nan")),
     "SPIDER"),
    ("istack_inf", mt.spider_file(np.ones((2, 3)), istack=float("inf")),
     "SPIDER"),
    ("iform_3_volume", mt.spider_file(np.ones((2, 3)), iform=3), "unknown"),
    ("labbyt_not_labrec_x_lenbyt", mt.spider_file(np.ones((2, 3)),
                                                   values={22: 99.0}),
     "unknown"),
    ("nrow_not_whole", mt.spider_file(np.ones((2, 3)), values={2: 2.5}),
     "unknown"),
    ("header_only_107_bytes", mt.spider_file(np.ones((2, 3)))[:107],
     "unknown"),
    ("negative_header_length", mt.spider_file(np.ones((2, 3)), lenbyt=-12,
                                               labrec=1), "SPIDER"),
    ("zero_width", mt.spider_file(np.ones((2, 3)), values={12: 0.0}),
     "unknown")])
def test_spider_cases(tmp_path, case, data, fmt):
    """SpiderImagePlugin: big-endian first, then little-endian; the header
    checks (whole numbers, iform, labbyt = labrec x lenbyt); the stack
    rules (a stack's first image after a second header; an image within a
    stack, Pillow's missing stkoffset, escapes; inconsistent values not
    opened); int() of NaN or infinity escapes; samples clamped and
    truncated."""
    assert image_io.format_of(data) == fmt
    _same_as_jax(tmp_path, data, fmt=fmt)


# -------------------------------------------------------------------- IM

def _im(kind: str, w: int, h: int, seed: int = 0, **kw) -> bytes:
    """An IM file of the type's random samples (float32 ones of no NaN for
    F;32F)."""
    raw = im.OPEN[kind][1]
    rng = np.random.default_rng(seed)
    if raw == "F;32F":
        body = rng.uniform(-9, 300, w * h).astype("<f4").tobytes()
    else:
        body = rng.integers(0, 256, mt.im_body_size(raw, w, h)).astype(
            np.uint8).tobytes()
    return mt.im_file(kind.encode(), w, h, body, **kw)


@pytest.mark.parametrize("kind", sorted(im.OPEN))
def test_im_every_type_of_the_open_table(tmp_path, kind):
    """Each image type of ImImagePlugin.OPEN (every raw layout, the bit
    depths F;2 to F;31 among them) at an odd size, random bytes: JAX's
    pixels, or both refuse (RLB, PA;L into LA)."""
    _same_as_jax(tmp_path, _im(kind, 7, 3, seed=len(kind)), fmt="IM")


def bit_twin(data: bytes, w: int, h: int, bits: int):
    """A Python twin of native.bit_decode (Pillow's BitDecode.c with IM's
    arguments): samples [h, w] float, or None where the data end first."""
    out = np.zeros((h, w))
    mask = (1 << bits) - 1
    buf = count = x = 0
    y = h - 1
    for byte in data:
        buf = (buf | byte << count) & (2 ** 64 - 1)
        count += 8
        while count >= bits:
            v = buf & mask
            buf = byte >> (8 - (count - bits)) if count > 32 else buf >> bits
            count -= bits
            out[y, x] = v
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x = count = 0
    return None


@pytest.mark.parametrize("bits", [b for b in range(2, 32) if b not in (8, 16)])
def test_bit_decoder_against_python_twin(tmp_path, bits):
    """native.bit_decode against its Python twin at each depth on random
    data (whole, long and cut short): the buffered bits left at a row's end
    reach the next row's first sample (the count is reset, the buffer not),
    more than 32 buffered bits keep the last byte's; and an IM file at the
    depth against JAX."""
    rng = np.random.default_rng(bits)
    for w, h in ((1, 1), (3, 2), (7, 3), (13, 2)):
        need = -(-w * bits // 8) * h
        for n in (need, need + 3, max(0, need - 1)):
            data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
            want = bit_twin(data, w, h, bits)
            if want is None:
                with pytest.raises(ValueError, match="truncated"):
                    native.bit_decode(data, 0, bits, w, h, "IM")
            else:
                np.testing.assert_array_equal(
                    native.bit_decode(data, 0, bits, w, h, "IM"),
                    want.astype(np.float32))
    data = mt.im_file(b"L*%d image" % bits, 5, 3, rng.integers(
        0, 256, -(-5 * bits // 8) * 3).astype(np.uint8).tobytes())
    _same_as_jax(tmp_path, data, fmt="IM")


@pytest.mark.parametrize("case,data,fmt", [
    ("colour_lut_makes_l_a_palette", _im("Greyscale image", 4, 2,
                                         lut=bytes(range(256)) * 2
                                         + bytes(256)), "IM"),
    ("grey_lut_not_linear_is_ignored", _im(
        "Greyscale image", 4, 2, lut=bytes(range(255, -1, -1)) * 3), "IM"),
    ("grey_linear_lut", _im("B4 image", 4, 2, lut=bytes(range(256)) * 3),
     "IM"),
    ("lut_cut_where_pillow_indexes_past_it", _im(
        "Greyscale image", 4, 2, lut=bytes(300)), "unknown"),
    ("lut_cut_where_pillow_does_not", mt.im_file(
        b"Greyscale image", 4, 2, b"", lut=bytes(range(256)) + bytes(
            range(1, 256)) + bytes(range(200))), "IM"),
    ("la_colour_lut_makes_pa", _im("LA image", 3, 2,
                                   lut=bytes(range(256)) * 2 + bytes(256)),
     "IM"),
    ("b2_colour_lut_reads_8_bits", mt.im_file(
        b"B2 image", 4, 2, bytes(range(8)), lut=bytes(range(256)) * 2
        + bytes(256)), "IM"),
    ("p_without_palette_is_black", _im("B4 image", 5, 3), "IM"),
    ("default_size_512", mt.im_file(b"Greyscale image", 0, 0, bytes(
        512 * 512), size=b"512*512")[:-1] + b"\x07", "IM"),
    ("no_size_line", b"Image type: Greyscale image\n\x1a" + bytes(512 * 512),
     "IM"),
    ("size_of_one_value", _im("Greyscale image", 3, 2, size=b"6"),
     "unknown"),
    ("size_of_three_values", _im("Greyscale image", 3, 2, size=b"3*2*1"),
     "IM"),
    ("size_float", _im("Greyscale image", 3, 2, size=b"3.0*2"), "IM"),
    ("size_not_a_number", _im("Greyscale image", 3, 2, size=b"3*x"), "IM"),
    ("size_zero", _im("Greyscale image", 3, 2, size=b"0*2"), "unknown"),
    ("size_past_the_pixel_limit", _im("Greyscale image", 3, 2,
                                      size=b"20000*20000"), "IM"),
    ("scale_not_a_number", _im("Greyscale image", 3, 2,
                               lines=(b"Scale (x,y): big",)), "IM"),
    ("type_outside_the_table_l", mt.im_file(b"L", 3, 2, bytes(6)), "IM"),
    ("type_outside_the_table_rgb", mt.im_file(b"RGB", 3, 2, bytes(18)),
     "IM"),
    ("empty_type", mt.im_file(b"", 3, 2, bytes(6)), "unknown"),
    ("no_standard_key", b"Colour: red\n\x1a" + bytes(64), "unknown"),
    ("line_over_100_bytes", b"Name: " + b"n" * 100 + b"\n\x1a" + bytes(64),
     "unknown"),
    ("line_without_a_key", b"Image type: Greyscale image\n:x\n\x1a"
     + bytes(64), "unknown"),
    ("blank_line_joins_the_next", b"Image type: Greyscale image\n\n"
     b"Image size (x*y): 2*2\n\x1a" + bytes(4), "unknown"),
    ("lone_cr_before_lines", b"\rImage type: Greyscale image\r\n\r"
     b"Image size (x*y): 2*2\r\n\x1a" + bytes(range(4)), "IM"),
    ("no_1a_after_nul", b"Image type: Greyscale image\n\0" + bytes(64),
     "unknown"),
    ("no_newline_in_first_100", b"Image type: Greyscale image" + b" " * 80
     + b"\n\x1a", "unknown"),
    ("bit_depth_cut_short", _im("L*12 image", 5, 3)[:-2], "IM")])
def test_im_cases(tmp_path, case, data, fmt):
    """ImImagePlugin's header and layouts: the Lut (a colour palette turns
    L into P and LA into PA, and B2 into 8-bit indices; a grey one is kept
    and applied by nothing; a palette cut where Pillow's scan indexes past
    it is not opened), P without a palette (black), the 512 x 512 default,
    sizes of one value (not opened), three values or floats (escape at
    load), a value neither int() nor float() reads (escapes), 0 (not
    opened), past the pixel limit (escapes); a type outside the table
    (the string is the mode, with the last layout); the header's lines (a
    standard key, 100 bytes, a key, a blank line joining the next, lone
    carriage returns, 0x1A after a NUL, a newline in the first 100
    bytes); bit-decoded data cut short."""
    assert image_io.format_of(data) == fmt
    _same_as_jax(tmp_path, data, fmt=fmt)


def test_rgb_t_planes_are_green_red_blue(tmp_path):
    """RGB3 and RYB3: three planes of the whole image, rows from the
    bottom, read as green, then red, then blue."""
    g, r, b = (np.full((2, 3), v, np.uint8) for v in (10, 20, 30))
    g[1, 0] = 99                       # the file's second row: the top row
    data = mt.im_file(b"RGB3 image", 3, 2, (g.tobytes() + r.tobytes()
                                            + b.tobytes()))
    got = _same_as_jax(tmp_path, data)
    assert got[0, 0].tolist() == [20, 99, 30]
    assert got[1, 1].tolist() == [20, 10, 30]


# ---------------------------------------------------------------- IM Tools

@pytest.mark.parametrize("case,lines,body,fmt", [
    ("plain", [b"width 4", b"height 2", b"pixel n8"], bytes(range(8)),
     "IMT"),
    ("comments_and_unknown_keys", [b"* made by hand", b"name x",
                                   b"pixel n8", b"height 2", b"width 4"],
     bytes(range(8)), "IMT"),
    ("width_abc", [b"width abc", b"height 2", b"pixel n8"], bytes(8),
     "IMT"),
    ("width_empty", [b"height 2", b"width ", b"pixel n8"], bytes(8), "IMT"),
    ("pixel_n16", [b"width 4", b"height 2", b"pixel n16"], bytes(8),
     "unknown"),
    ("no_height", [b"width 4", b"pixel n8"], bytes(8), "unknown"),
    ("negative_width", [b"width -4", b"height 2", b"pixel n8"], bytes(8),
     "unknown"),
    ("one_byte_line_ends_header", [b"width 4", b"height 2", b"pixel n8",
                                   b"x"], bytes(8), "IMT"),
    ("lone_star_ends_header", [b"*", b"width 4", b"height 2", b"pixel n8"],
     bytes(8), "unknown"),
    ("line_of_no_pair_ends_header", [b"width 4", b"height 2", b"pixel n8",
                                     b"Width 4"], bytes(8), "IMT"),
    ("long_line_over_reads", [b"width 4", b"x" * 150, b"height 2",
                              b"pixel n8"], bytes(8), "unknown"),
    ("size_past_the_pixel_limit", [b"width 20000", b"height 20000",
                                   b"pixel n8"], bytes(8), "IMT")])
def test_imt_cases(tmp_path, case, lines, body, fmt):
    """ImtImagePlugin's buffered header: "key value" lines, '*' comments,
    int() of width and height (its ValueError escapes), "pixel n8" the only
    mode, a line of one byte or of no pair ending the header before its
    form feed (opened, nothing to load), a line past the buffer."""
    data = mt.imt_file(0, 0, body, lines)
    assert image_io.format_of(data) == fmt
    _same_as_jax(tmp_path, data, fmt=fmt)


# ------------------------------------------------------------------ IPTC

def _grey_jpeg(h, w, seed=0):
    return mt._grey_jpeg(np.random.default_rng(seed).integers(
        0, 256, (h, w)), 95)


@pytest.mark.parametrize("layers,band", [(3, 0), (3, 1), (3, 2), (3, -1),
                                         (4, 0), (4, 1), (4, 2), (4, 3),
                                         (4, -1)])
def test_iptc_band_of_rgb_and_cmyk(tmp_path, layers, band):
    """A raw band of an RGB or CMYK stream: the grey image in the band's
    place of an otherwise black image (band 2 of RGB is green only, -1 the
    last), CMYK then through cmyk2rgb."""
    g = np.arange(20, dtype=np.uint8).reshape(4, 5) * 12
    got = _same_as_jax(tmp_path, mt.iptc_file(g.tobytes(), 5, 4, layers, 1,
                                              band=band))
    if layers == 3:
        want = np.zeros((4, 5, 3), np.uint8)
        want[..., band] = g
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,data,fmt", [
    ("jpeg_grey_in_l", mt.iptc_file(_grey_jpeg(9, 7), 7, 9, compression=5),
     "IPTC"),
    ("jpeg_grey_band_1_chunked", mt.iptc_file(_grey_jpeg(5, 6), 6, 5, 3, 1,
                                              5, band=1, chunk=13), "IPTC"),
    ("jpeg_grey_band_0_cmyk", mt.iptc_file(_grey_jpeg(5, 6), 6, 5, 4, 1, 5,
                                           band=0), "IPTC"),
    ("jpeg_size_is_the_nested_images", mt.iptc_file(_grey_jpeg(9, 7), 1, 1,
                                                    compression=5), "IPTC"),
    ("jpeg_rgb_as_band_1", mt.iptc_file(
        mt._pillow(PIL.new("RGB", (3, 2), (9, 8, 7)), "JPEG"), 3, 2, 3, 1,
        5, band=1), "IPTC"),
    ("nested_png_in_l", mt.iptc_file(mt._pillow(PIL.new(
        "RGB", (3, 2), (9, 80, 7)), "PNG"), 3, 2, compression=5), "IPTC"),
    ("nested_not_an_image", mt.iptc_file(b"not an image", 3, 2,
                                         compression=5), "IPTC"),
    ("one_bit_pnm_in_band_0", mt.iptc_file(b"P4\n3 2\n\x40\x80", 3, 2, 3,
                                           1, 5, band=0), "IPTC"),
    ("raw_extra_data", mt.iptc_file(bytes(range(30)), 5, 4), "IPTC"),
    ("no_image_field", mt.iptc_file(b"", 2, 2), "IPTC"),
    ("no_compression_field", mt.iptc_file(bytes(4), 2, 2).replace(
        mt.iptc_field(3, 120, b"\x01"), b""), "IPTC"),
    ("compression_of_two_bytes", mt.iptc_file(bytes(4), 2, 2).replace(
        mt.iptc_field(3, 120, b"\x01"), mt.iptc_field(3, 120, b"\x00\x01")),
     "IPTC"),
    ("no_mode_field", mt.iptc_file(bytes(4), 2, 2).replace(
        mt.iptc_field(3, 60, b"\x01\x00"), b""), "unknown"),
    ("two_layers_no_mode", mt.iptc_file(bytes(4), 2, 2, 2, 1), "unknown"),
    ("mode_field_twice", mt.iptc_file(bytes(4), 2, 2, fields=[
        mt.iptc_field(3, 60, b"\x01\x00")]), "unknown"),
    ("zero_width", mt.iptc_file(bytes(4), 0, 2), "unknown"),
    ("record_10", b"\x1c\x0a\x01\x00\x02ab" + mt.iptc_file(bytes(4), 2, 2),
     "unknown"),
    ("size_byte_0x80", mt.iptc_file(bytes(4), 2, 2, fields=[
        b"\x1c\x02\x05\x80\x00"]), "IPTC"),
    ("size_byte_0x80_in_4_bytes", mt.iptc_file(bytes(4), 2, 2, fields=[
        b"\x1c\x02\x05\x80"]), "unknown"),
    ("size_byte_0x81", mt.iptc_file(bytes(4), 2, 2, fields=[
        b"\x1c\x02\x05\x81\x03abc"]), "IPTC"),
    ("size_byte_0x85", mt.iptc_file(bytes(4), 2, 2, fields=[
        b"\x1c\x02\x05\x85\x00"]), "IPTC"),
    ("nul_padding_after", mt.iptc_file(bytes(4), 2, 2, tail=bytes(9)),
     "IPTC"),
    ("another_field_after", mt.iptc_file(bytes(4), 2, 2,
                                         tail=mt.iptc_field(2, 5, b"x")),
     "IPTC"),
    ("short_tail_after", mt.iptc_file(bytes(4), 2, 2, tail=b"\x1c\x02"),
     "IPTC"),
    ("band_past_the_mode", mt.iptc_file(bytes(4), 2, 2, 3, 1, band=3),
     "IPTC"),
    ("band_field_empty", mt.iptc_file(bytes(4), 2, 2, 3, 1, fields=[
        mt.iptc_field(3, 65, b"")]), "unknown")])
def test_iptc_cases(tmp_path, case, data, fmt):
    """IptcImagePlugin: nested JPEGs (grey in L and in a band; RGB in L
    decodes as RGB; RGB as a band escapes, mode mismatch), the nested
    image's own size, any format Image.open reads nested (a PNG), a 1-bit
    PNM in band 0 (Image.merge does not check the first band's mode); what
    escapes Image.open (no image field, an unknown or missing compression,
    a size byte over 0x84, a band past the mode's, a nested file that does
    not decode); what does not open (no (3,60), a mode of no layers'
    count, a repeated (3,60), an empty image, a record not in the list, an
    empty (3,65)); field sizes of 0x80 and 0x81 (every field header is 5
    bytes read, so a 4-byte 0x80 field shifts the next); what follows the
    image data (NUL padding or another field end it, a short tail
    escapes)."""
    assert image_io.format_of(data) == fmt
    _same_as_jax(tmp_path, data, fmt=fmt)


# -------------------------------------------- NaN, and what escapes

@pytest.mark.parametrize("make", [
    lambda: mt.spider_file(np.array([[np.nan, 1.0]])),
    lambda: mt.fits_file(np.frombuffer(np.array(      # NaN read LE
        [np.nan, 1.0], "<f4").tobytes(), ">f4").reshape(1, 2), -32),
    lambda: mt.im_file(b"L 32F image", 2, 1, np.array(
        [np.nan, 2.0], "<f4").tobytes())])
def test_nan_sample_is_refused_where_pillow_is_undefined(tmp_path, make):
    """A NaN float sample, which Pillow's F -> L casts to 8 bits as C
    leaves undefined: Pillow returns some byte, the port refuses the file,
    naming the NaN (ROADMAP's standing records)."""
    data = make()
    path = str(tmp_path / "nan.tex")
    open(path, "wb").write(data)
    _jax_u8(path)                               # Pillow decodes it
    with pytest.raises(ValueError, match="NaN") as e:
        mesh_io.load_image(path)
    assert path in str(e.value)


@pytest.mark.parametrize("case,data,error", [
    ("imt_width_abc", mt.imt_file(0, 0, bytes(4), [b"width abc", b"height 2",
                                                    b"pixel n8"]),
     ValueError),
    ("im_size_abc", mt.im_file(b"Greyscale image", 0, 0, bytes(4),
                               size=b"abc"), ValueError),
    ("iptc_field_size_133", mt.iptc_file(bytes(4), 2, 2, fields=[
        b"\x1c\x02\x05\x85\x00"]), OSError),
    ("iptc_unknown_compression", mt.iptc_file(bytes(4), 2, 2, compression=3),
     OSError),
    ("fits_no_image_data", mt.fits_hdu([mt.fits_card(b"SIMPLE", b"T"),
                                        mt.fits_card(b"NAXIS", b"0")])
     + bytes(80), ValueError),
    ("spider_image_in_a_stack", mt.spider_file(np.ones((2, 2)),
                                               imgnumber=1), AttributeError),
    ("im_decompression_bomb", mt.im_file(b"Greyscale image", 0, 0, bytes(4),
                                         size=b"20000*20000"),
     PIL.DecompressionBombError)])
def test_what_escapes_image_open_is_a_refusal(tmp_path, case, data, error):
    """Image.open catches only SyntaxError, IndexError, TypeError and
    struct.error from a plugin's _open: each of these escapes it (so JAX's
    loader fails on the file), and the port raises a ValueError naming the
    format and the case, never going on to the next format."""
    with pytest.raises(error):
        PIL.open(io.BytesIO(data))
    fmt = image_io.format_of(data)
    assert fmt in ("IMT", "IM", "IPTC", "FITS", "SPIDER")
    _same_as_jax(tmp_path, data, fmt=fmt)


def test_iptc_without_mode_field_is_not_opened(tmp_path):
    """A stream without its (3,60) field: _open's KeyError, which
    ImageFile turns into SyntaxError, so Image.open goes on and no plugin
    opens it (it does not escape); the port names no IPTC file."""
    data = mt.iptc_file(bytes(4), 2, 2).replace(
        mt.iptc_field(3, 60, b"\x01\x00"), b"")
    assert _pillow_format(data) is None
    assert image_io.format_of(data) == "unknown"
    _same_as_jax(tmp_path, data, fmt="unknown format")


# ---------------------------------------------------------------- dispatch

def test_read_places_the_four_tries_as_image_id():
    """IM, IMT and IPTC sit between ICO and McIdas, SPIDER between SGI and
    Sun raster, as in Pillow's Image.ID; FITS and McIdas decode."""
    order = [n for n, _, _ in image_io._PILLOW_ORDER]
    assert order.index("ICO") + 1 == order.index("IM") == \
        order.index("IMT") - 1 == order.index("IPTC") - 2 == \
        order.index("McIdas") - 3
    assert order.index("SGI") + 1 == order.index("SPIDER") == \
        order.index("Sun raster") - 1
    for name in ("FITS", "McIdas", "IM", "IMT", "IPTC", "SPIDER"):
        assert name in image_io.READ
    PIL.init()
    ids = [i for i in PIL.ID if i in ("ICO", "IM", "IMT", "IPTC", "MCIDAS",
                                      "SGI", "SPIDER", "SUN")]
    assert ids == ["ICO", "IM", "IMT", "IPTC", "MCIDAS", "SGI", "SPIDER",
                   "SUN"]
    assert all(PIL.OPEN[i][1] is None for i in ("IM", "IMT", "IPTC",
                                                "SPIDER"))


def test_decodes_without_pillow(monkeypatch):
    """The mesh loader's texture path with Pillow blocked: every fixture
    JAX decodes decodes through image_io.format_of to JAX's pixels."""
    import builtins

    want = {e["name"]: _jax_u8(os.path.join(FOLDER, e["name"]))
            for e in MANIFEST if e["sha256"]}
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    for name, pixels in want.items():
        path = os.path.join(FOLDER, name)
        assert image_io.format_of(open(path, "rb").read()) in (
            "FITS", "McIdas", "SPIDER", "IM", "IMT", "IPTC")
        np.testing.assert_array_equal(_port_u8(path), pixels, err_msg=name)


def test_chip_smoke_writers_hold_their_texels():
    """chip_smoke.py phase 18c's writers of these formats (science_writers):
    each file decodes, in the port and in Pillow, to the texels it says it
    holds."""
    import chip_smoke

    texels = np.random.default_rng(4).integers(0, 256, (96, 128, 3),
                                               dtype=np.uint8)
    out = chip_smoke.science_writers(texels)
    assert {image_io.format_of(d) for d, _ in out.values()} == {
        "IM", "FITS", "SPIDER", "McIdas", "IMT", "IPTC"}
    for name, (data, held) in out.items():
        np.testing.assert_array_equal(image_io.decode_image(data), held,
                                      err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")), held,
            err_msg=name)
    assert struct.unpack(">f", out["texels_green.spi"][0][:4])[0] == 1.0
