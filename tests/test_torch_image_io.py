"""The port's texture decoders (cge_tpu_torch/scene/image_io.py: PNG and
BMP; scene/jpeg.py: JPEG; scene/tga.py, pnm.py, gif.py and psd.py: TGA,
PNM, GIF and PSD; the byte-serial parts in native/cge_image.cpp) against
Pillow, which the JAX package's loader uses: seeded numpy images of every
colour type, every row filter and odd sizes, written by the port's
`write_png` and by Pillow; every fixture of tests/torch_textures/
(jax_references/make_textures.py) against JAX's `load_image`; random
images Pillow saves in random PNG, BMP and JPEG modes, and in random TGA,
GIF and PNM modes; the native PNG row filters against their Python twin;
damaged files of each new format. Pixels must be equal exactly (u8 / 255
as float32, as stb_image and the JAX loader give them)."""

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
    table, interlace, offset and transparency cases and every PSD colour
    mode raw and PackBits; the set stays under 1 MB with the 1024x1024
    progressive JPEG in it."""
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
    ("psd_cmyk_rle.psd", "texture.gif")])
def test_swapped_extensions_decode_by_signature(tmp_path, fixture, name):
    """A PNG named .jpg, a JPEG named .png, a BMP named .tex, and TGA,
    PNM, GIF and PSD files under other formats' names load through the
    mesh loader's texture path as JAX loads them."""
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
    ("tiff", lambda: _pillow_saved("TIFF"), r"TIFF"),
    ("webp", lambda: _pillow_saved("WEBP"), r"WebP"),
    ("gif", lambda: _pillow_saved("GIF")[:-8], r"GIF.*truncated"),
    ("dds", lambda: _pillow_saved("DDS", "RGBA"), r"DDS"),
    ("pam", lambda: b"P7\nWIDTH 4\nHEIGHT 4\n", r"PAM"),
    ("psd_lab", lambda: make_textures.psd_file(
        2, 1, 9, 8, [np.zeros((1, 2), np.uint8)] * 3), r"LAB PSD"),
    ("bmp_jpeg", lambda: make_textures.bmp_file(1, 1, 24, b"\xff\xd8",
                                                compression=4), r"JPEG"),
    ("unknown", lambda: b"\x00\x01\x02\x03 no image", r"unknown format")])
def test_unsupported_formats_name_their_format(tmp_path, kind, make, words):
    """Formats the port does not read raise a ValueError that names them
    (ROADMAP queue 6 lists them in order), whatever the file's name; so
    does a GIF, which the port reads, cut short."""
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
    path.write_bytes(b"II*\x00 a TIFF header")
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
    ("psd_rgb_raw.psd", (13, 2), "PSD.*not enough channels")])
def test_damaged_files_raise_naming_file_and_format(tmp_path, name, how,
                                                   words):
    """A truncated or corrupt TGA, PNM, GIF or PSD raises a ValueError
    that names the file and the format (and so does JAX's loader: Pillow
    refuses each of them too)."""
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
