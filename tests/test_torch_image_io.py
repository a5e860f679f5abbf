"""The port's texture decoders (cge_tpu_torch/scene/image_io.py: PNG and
BMP; scene/jpeg.py and native/cge_image.cpp: JPEG) against Pillow, which
the JAX package's loader uses: seeded numpy images of every colour type,
every row filter and odd sizes, written by the port's `write_png` and by
Pillow; every fixture of tests/torch_textures/ (jax_references/
make_textures.py) against JAX's `load_image`; random images Pillow saves
in random PNG, BMP and JPEG modes. Pixels must be equal exactly (u8 / 255
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
    Adam7, each BMP kind and the JPEG kinds; the set stays under 1 MB
    with the 1024x1024 progressive JPEG in it."""
    names = {f["name"] for f in MANIFEST["files"]}
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
    ("bmp_24bit.bmp", "texture.tex")])
def test_swapped_extensions_decode_by_signature(tmp_path, fixture, name):
    """A PNG named .jpg, a JPEG named .png and a BMP named .tex load
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
    ("tiff", lambda: _pillow_saved("TIFF"), r"TIFF"),
    ("webp", lambda: _pillow_saved("WEBP"), r"WebP"),
    ("gif", lambda: _pillow_saved("GIF"), r"GIF"),
    ("bmp_jpeg", lambda: make_textures.bmp_file(1, 1, 24, b"\xff\xd8",
                                                compression=4), r"JPEG"),
    ("unknown", lambda: b"\x00\x01\x02\x03 no image", r"unknown format")])
def test_unsupported_formats_name_their_format(tmp_path, kind, make, words):
    """Formats the port does not read raise a ValueError that names them
    (ROADMAP queue 6 lists them in order), whatever the file's name."""
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
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.load_image(str(path))
