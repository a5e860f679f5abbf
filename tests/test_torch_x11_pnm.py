"""The port's readers of Pillow's other PNM modes, XBM and XPM
(cge_tpu_torch/scene/pnm.py, xbm.py, xpm.py; XBM's hex bytes in
native/cge_raster.cpp) against Pillow 12, which the JAX package's loader
uses: every fixture of tests/torch_textures/x11_pnm/ against JAX's
`load_image` and its manifest's hash (the damaged-file fixtures of
tests/test_torch_texture_faults.py among them), files Pillow writes (XBM
of mode 1, PPM of mode F) at seeded sizes, hand-made files of each quirk
Pillow's plugins have (make_textures.pnm_ext_file, pfm_file, xbm_file,
xpm_file), files cut at several lengths, and the cases Pillow refuses,
each refusal a ValueError that names the file and the format. Pixels must
be equal exactly."""

import hashlib
import json
import os

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, mesh_io, pnm, xbm, xpm
from jax_references import make_textures as mt

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_textures", "x11_pnm")
with open(os.path.join(FOLDER, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
KINDS = {"pnm_pf", "pnm_cmyk", "pnm_rgba", "pnm_p", "xbm", "xpm", "xpm_rgb",
         "jpeg_no_eoi", "jpeg_header", "png_chunks", "ojpeg_tables"}


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


def test_fixtures_cover_every_new_kind():
    """The folder names each kind of this slice: the PNM modes, XBM, XPM
    (palette and RGB), and the damaged files of each repaired fault; its
    files stay small."""
    assert {e["kind"] for e in MANIFEST} == KINDS
    assert sum(e["bytes"] for e in MANIFEST) < 64 << 10
    names = {e["name"] for e in MANIFEST}
    assert any(n.startswith("xbm_pillow") for n in names)
    assert any(n.startswith("pfm_pillow") for n in names)


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_matches_jax_and_its_hash(name):
    """Each fixture decodes to JAX's pixels, whose hash its manifest
    holds (the hash chip_smoke.py checks on the card's machine)."""
    entry = next(e for e in MANIFEST if e["name"] == name)
    path = os.path.join(FOLDER, name)
    got = _port_u8(path)
    np.testing.assert_array_equal(got, _jax_u8(path))
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_cut_short_matches_jax(tmp_path, name):
    """Each fixture cut at four lengths: JAX's pixels, or both refuse."""
    data = open(os.path.join(FOLDER, name), "rb").read()
    for k in (1, 2, 3, 4):
        _same_as_jax(tmp_path, data[:len(data) * k // 5], f"cut{k}.tex")


@pytest.mark.parametrize("scale", [-1.0, -0.25, 1.0, 3.5])
@pytest.mark.parametrize("hw", [(1, 1), (3, 7), (8, 2)])
def test_pf_values_and_byte_orders(tmp_path, hw, scale):
    """Pf in either byte order (the scale's sign), rows bottom-up, values
    from far below 0 to far past 255, fractions and infinities: f2l's
    clamp and truncation."""
    rng = np.random.default_rng(hw[0] * 10 + hw[1])
    v = rng.uniform(-600.0, 600.0, hw).astype(np.float32)
    v.reshape(-1)[:3] = (np.inf, -np.inf, 254.9999)[:v.size]
    assert _same_as_jax(tmp_path, mt.pfm_file(v, scale)) is not None


def test_pf_pillow_written(tmp_path):
    """PPM files Pillow writes of mode F ("Pf", scale -1.0)."""
    rng = np.random.default_rng(4)
    for hw in ((1, 1), (4, 9), (13, 3)):
        v = rng.uniform(-20.0, 280.0, hw).astype(np.float32)
        data = mt._pillow(PIL.fromarray(v, "F"), "PPM")
        assert data.startswith(b"Pf")
        assert _same_as_jax(tmp_path, data) is not None


@pytest.mark.parametrize("head,words", [
    ("Pf\n2 1\n0.0\n", "scale"), ("Pf\n2 1\nnan\n", "scale"),
    ("Pf\n2 1\ninf\n", "scale"), ("Pf\n2 1\nabc\n", "scale"),
    ("Pf\n2 1\n-1.0\n", "truncated")])
def test_pf_refusals(tmp_path, head, words):
    """A scale of 0, NaN, infinite or no number, and data cut short: Pillow
    refuses, and the port raises naming PNM and the case."""
    data = head.encode() + (b"\0" * 4 if words == "truncated" else b"\0" * 8)
    assert _same_as_jax(tmp_path, data, fmt=words) is None


def test_pf_nan_sample_refused(tmp_path):
    """A NaN sample: Pillow's f2l casts it as C leaves undefined (0 on this
    host), a standing record; the port refuses the file naming the case."""
    data = mt.pfm_file(np.array([[1.0, np.nan]], np.float32))
    path = str(tmp_path / "nan.pfm")
    open(path, "wb").write(data)
    with pytest.raises(ValueError, match="NaN") as e:
        mesh_io.load_image(path)
    assert path in str(e.value) and "PNM" in str(e.value)


@pytest.mark.parametrize("magic", ["P0CMYK", "PyCMYK", "PyRGBA", "PyP"])
@pytest.mark.parametrize("maxval", [1, 15, 255, 256, 1000, 65535])
def test_other_modes_at_each_maxval(tmp_path, magic, maxval):
    """P0CMYK and PyCMYK through Pillow's CMYK -> RGB, PyRGBA without its
    alpha, PyP black, at maxvals that read raw (255) and rescaled (one or
    two bytes a sample), samples past maxval included."""
    rng = np.random.default_rng(maxval)
    bands = {"PyP": (), "PyRGBA": (4,)}.get(magic, (4,))
    v = rng.integers(0, min(maxval * 2, 65535) + 1, (5, 7) + bands)
    assert _same_as_jax(tmp_path, mt.pnm_ext_file(magic, v, maxval)) \
        is not None


@pytest.mark.parametrize("data,fmt", [
    (b"P0CMYK\n2 1\n255\n" + bytes(7), "PNM"),        # cut short
    (b"PyRGBA 1 1 0\n" + bytes(4), "PNM"),             # maxval 0
    (b"PyP 1 1 65536\n" + bytes(2), "PNM"),            # maxval too big
    (b"P0CMYKX 1 1 255\n" + bytes(4), "PNM"),          # magic of 7
    (b"Py 1 1 255\n\0", "PNM"),                        # no such magic
    (b"PyRGB 1 1 255\n" + bytes(3), "PNM"),
    (b"PF\n1 1\n-1.0\n" + bytes(12), "colour PFM"),    # Pillow: no plugin
    (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" + bytes(3),
     "PAM"),
    (b"PyP 0 1 255\n", "PNM")])                        # empty
def test_pnm_refusals_name_their_case(tmp_path, data, fmt):
    """What Pillow refuses raises, naming the format: cut data, maxvals
    out of range, magic numbers its table has not, colour PFM and PAM
    (which its PNM plugin does not take), an empty image."""
    assert _same_as_jax(tmp_path, data, fmt=fmt) is None


def test_pnm_accepts_as_pillows_test():
    """format_of takes "P" and one of 0-6, f, y as PNM (Pillow's _accept),
    and names colour PFM and PAM otherwise."""
    for head in (b"P0CMYK", b"Pf\n", b"PyP", b"PyRGBA", b"PyCMYK", b"P1",
                 b"P6", b"P0", b"Py"):
        assert image_io.format_of(head + b" 1 1 255\n") == "PNM", head
        assert pnm.accept(head)
    assert image_io.format_of(b"PF\n1 1\n-1\n") == "colour PFM"
    assert image_io.format_of(b"P7\nWIDTH 1\n") == "PAM"
    assert image_io.format_of(b"P7 332\n") == "XV thumbnail"


@pytest.mark.parametrize("hw", [(1, 1), (1, 8), (3, 9), (16, 16), (7, 33),
                                (40, 5)])
def test_xbm_pillow_written(tmp_path, hw):
    """XBMs Pillow writes of random bitmaps, with and without a hotspot."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    im = PIL.fromarray(rng.integers(0, 2, hw).astype(bool))
    assert _same_as_jax(tmp_path, mt._pillow(im, "XBM")) is not None
    assert _same_as_jax(tmp_path, mt._pillow(im, "XBM", hotspot=(0, 1))) \
        is not None


def test_xbm_set_bit_is_white():
    """The bytes 0x01, 0x02 of a 10-pixel row: white, eight blacks, white
    (least significant bit first)."""
    data = (b"#define a_width 10\n#define a_height 1\n"
            b"static char a_bits[] = {0x01,0x02};")
    assert xbm.decode_xbm(data)[0, :, 0].tolist() == [255] + [0] * 8 + [255]


@pytest.mark.parametrize("fmt", ["0x{:02x}", "0x{:X}", "x{:x}", "0x{:02X}h",
                                 "{:02x}", "0X{:02x}"])
@pytest.mark.parametrize("per_line", [1, 5, 64])
def test_xbm_hex_bytes_as_pillows_decoder(tmp_path, fmt, per_line):
    """Each byte from the two characters after the next 'x': upper-case
    digits, one digit (its high nibble), a letter after the digits, no
    'x' at all or an upper-case 'X' (no bytes: Pillow reads the file as
    truncated)."""
    bits = np.random.default_rng(per_line).integers(0, 2, (4, 11))
    _same_as_jax(tmp_path, mt.xbm_file(bits, "q", fmt=fmt,
                                       per_line=per_line), fmt="XBM")


@pytest.mark.parametrize("case,data", [
    ("leading_whitespace", b" \t\n#define a_width 2\n#define a_height 1\n"
     b"char a_bits[] = { 0x03 };"),
    ("ten_spaces", b" " * 10 + b"#define a_width 2\n#define a_height 1\n"
     b"char a_bits[] = { 0x03 };"),
    ("hotspot", b"#define a_width 3\n#define a_height 1\n#define a_x_hot 1"
     b"\n#define a_y_hot 0\nstatic char a_bits[] = {0x05};"),
    ("crlf", b"#define a_width 3\r\n#define a_height 2\r\nstatic unsigned "
     b"char a_bits[] = {\r\n0x05, 0x02};\r\n"),
    ("two_bits_arrays", b"#define a_width 8\n#define a_height 1\n"
     b"/* b_bits[] */ static char a_bits[] = {0xf0};"),
    ("header_past_512", b"#define a_width 8\n#define a_height 1\n"
     + b" " * 500 + b"static char a_bits[] = {0xf0};"),
    ("no_height", b"#define a_width 8\nstatic char a_bits[] = {0xf0};"),
    ("short_data", b"#define a_width 16\n#define a_height 2\n"
     b"static char a_bits[] = {0xf0, 0x01, 0x"),
    ("zero_width", b"#define a_width 0\n#define a_height 2\n"
     b"static char a_bits[] = {0xf0, 0x01};"),
    ("name_with_underscores", b"#define my_icon_width 4\n#define "
     b"my_icon_height 1\nstatic char my_icon_bits[] = {0x09};")])
def test_xbm_header_cases(tmp_path, case, data):
    """Pillow's header expression over the first 512 bytes: leading
    whitespace (its test sees 16 bytes), a hotspot, CR LF, "_bits[]" twice
    (the data after the last), and what it refuses: a header past 512
    bytes, no height, data cut short, an empty image."""
    fmt = "unknown" if case == "ten_spaces" else "XBM"
    _same_as_jax(tmp_path, data, fmt=fmt)


def _xpm(head: bytes, colours: list, rows: list) -> bytes:
    return b"\n".join([b"/* XPM */", b"static char *x[] = {", head]
                      + colours + rows) + b"\n};\n"


@pytest.mark.parametrize("case,data", [
    ("basic", _xpm(b'"3 2 2 1",', [b'"a c #ff0000",', b'"b c #00ff00",'],
                   [b'"aba",', b'"bbb"'])),
    ("pixels_line", _xpm(b'"2 1 1 1",', [b'"a c #123456",'],
                         [b"/* pixels */", b'"aa"'])),
    ("pixels_line_twice", _xpm(b'"2 2 1 1",', [b'"a c #123456",'],
                               [b"/* pixels */", b'"aa",', b"/* pixels */",
                                b'"aa"'])),
    ("symbolic_and_mono_keys", _xpm(b'"2 1 2 2",',
                                    [b'"aa s bg m black c #0a0b0c",',
                                     b'"bb g #ffffff c #102030 m white",'],
                                    [b'"aabb"'])),
    ("hex_forms", _xpm(b'"4 1 4 1",', [b'"a c #FFF",', b'"b c #1_2",',
                                       b'"c c #+7f",', b'"d c #123456789",'],
                       [b'"abcd"'])),
    ("none_unused", _xpm(b'"2 1 2 1",', [b'"a c #ff0000",', b'"n c None",'],
                         [b'"aa"'])),
    ("none_used", _xpm(b'"2 1 2 1",', [b'"a c #ff0000",', b'"n c None",'],
                       [b'"an"'])),
    ("symbolic_colour", _xpm(b'"1 1 1 1",', [b'"a c red",'], [b'"a"'])),
    ("no_c_key", _xpm(b'"1 1 1 1",', [b'"a m #ffffff",'], [b'"a"'])),
    ("c_without_value", _xpm(b'"1 1 1 1",', [b'"a c",'], [b'"a"'])),
    ("bad_hex", _xpm(b'"1 1 1 1",', [b'"a c #xyz",'], [b'"a"'])),
    ("missing_key", _xpm(b'"2 1 1 1",', [b'"a c #ff0000",'], [b'"ab"'])),
    ("too_few_pixels", _xpm(b'"3 2 1 1",', [b'"a c #ff0000",'],
                            [b'"aaa",', b'"a"'])),
    ("rows_of_any_length", _xpm(b'"3 2 1 1",', [b'"a c #ff0000",'],
                                [b'"aaaa",', b'"aa"'])),
    ("empty_width", _xpm(b'" 2 1 1",', [b'"a c #ff0000",'], [b'"a"'])),
    ("no_values_line", b"/* XPM */\nstatic char *x[] = {\n};\n"),
    ("colour_lines_cut", _xpm(b'"1 1 3 1",', [b'"a c #ff0000",'], [])),
    ("duplicate_keys", _xpm(b'"2 1 3 1",', [b'"a c #ff0000",',
                                            b'"b c #00ff00",',
                                            b'"a c #0000ff",'],
                            [b'"ab"'])),
    ("zero_height", _xpm(b'"2 0 1 1",', [b'"a c #ff0000",'], [b'"aa"'])),
    ("spaced_key", _xpm(b'"2 1 2 2",', [b'"  c #ff0000",', b'". c #00ff00",'],
                        [b'"  . "']))])
def test_xpm_cases(tmp_path, case, data):
    """XpmImagePlugin line by line: the values line, keys and specs of
    each colour line (only "c #..." read, Python's int() of the digits, its
    low 24 bits), "None" left out of the palette (its pixels raise), a
    symbolic colour or a missing "c" raising, "/* pixels */" passed over
    once, the text between a row's first and last quotes, duplicate keys
    (the last colour in the first one's place), and too few pixels."""
    _same_as_jax(tmp_path, data, fmt="XPM")


@pytest.mark.parametrize("n,bpp", [(1, 1), (2, 1), (90, 1), (256, 2),
                                   (257, 2), (400, 3)])
def test_xpm_palette_and_rgb(tmp_path, n, bpp):
    """Palette images up to 256 colours, RGB ones past them (the pixels
    looked up in the colour table), at 1 to 3 characters a pixel."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, (6, 11))
    data = mt.xpm_file(idx, mt.xpm_keys(n, bpp),
                       mt.rgb_specs(rng.integers(0, 256, (n, 3))))
    assert _same_as_jax(tmp_path, data) is not None


def test_xpm_none_raises_in_the_port_too(tmp_path):
    """A "c None" colour that pixels use: Pillow opens the file and raises
    in convert("RGB") (palette.index); so does the port, naming XPM."""
    data = _xpm(b'"2 1 2 1",', [b'"a c #ff0000",', b'"n c None",'],
                [b'"na"'])
    path = str(tmp_path / "none.xpm")
    open(path, "wb").write(data)
    with PIL.open(path) as im:
        assert im.format == "XPM"
        with pytest.raises(ValueError):
            im.convert("RGB")
    with pytest.raises(ValueError, match="XPM") as e:
        mesh_io.load_image(path)
    assert path in str(e.value)


def test_new_formats_decode_without_pillow(tmp_path, monkeypatch):
    """The mesh loader's texture path with Pillow blocked: every fixture
    of the folder decodes through image_io.format_of to JAX's pixels, and
    format_of names PNM, XBM and XPM for them."""
    import builtins

    want = {e["name"]: _jax_u8(os.path.join(FOLDER, e["name"]))
            for e in MANIFEST}
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    for e in MANIFEST:
        path = os.path.join(FOLDER, e["name"])
        data = open(path, "rb").read()
        fmt = image_io.format_of(data)
        assert fmt in image_io.READ
        if e["kind"].startswith("pnm"):
            assert fmt == "PNM"
        elif e["kind"].startswith(("xbm", "xpm")):
            assert fmt == e["kind"][:3].upper()
        np.testing.assert_array_equal(_port_u8(path), want[e["name"]],
                                      err_msg=e["name"])


def test_xbm_bytes_against_python_twin():
    """native.xbm_bytes against XbmDecode.c's loop in Python on seeded
    text of hex digits, 'x's, other characters and cut ends."""
    def twin(data, offset, count):
        def hexv(c):
            for lo, hi, base in ((48, 57, 0), (97, 102, 10), (65, 70, 10)):
                if lo <= c <= hi:
                    return c - lo + base
            return 0
        out, pos = [], offset
        while len(out) < count:
            while pos < len(data) and data[pos] != 0x78:
                pos += 1
            if len(data) - pos < 3:
                return None
            out.append((hexv(data[pos + 1]) << 4) + hexv(data[pos + 2]))
            pos += 3
        return out

    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"x0123456789abcdefABCDEFxg, \n", np.uint8)
    for _ in range(300):
        data = bytes(rng.choice(alphabet, int(rng.integers(0, 80))))
        count = int(rng.integers(0, 20))
        want = twin(data, 0, count)
        if want is None:
            with pytest.raises(ValueError, match="XBM"):
                native.xbm_bytes(data, 0, count)
        else:
            assert native.xbm_bytes(data, 0, count).tolist() == want


def test_dispatch_of_first_bytes():
    """Pillow's order and tests: "#define" after whitespace within the
    first 16 bytes is XBM, "/* XPM */" XPM; a file of neither is named by
    what takes it."""
    assert image_io.format_of(b"\n\n#define a_width 1\n") == "XBM"
    assert image_io.format_of(b" " * 9 + b"#define a_width 1\n") == "XBM"
    assert image_io.format_of(b" " * 10 + b"#define a_width 1\n") == \
        "unknown"
    assert image_io.format_of(b"/* XPM */\n") == "XPM"
    assert image_io.format_of(b"/*XPM*/\n") == "unknown"
    assert xpm.accept(b"/* XPM */") and not xpm.accept(b" /* XPM */")


def test_chip_smoke_writers_hold_their_texels():
    """chip_smoke.py phase 18c's writers of these formats (x11_writers):
    each file decodes, in the port and in Pillow, to the texels it says it
    holds."""
    import io

    import chip_smoke

    texels = np.random.default_rng(3).integers(0, 256, (128, 128, 3),
                                               dtype=np.uint8)
    out = chip_smoke.x11_writers(texels)
    assert {image_io.format_of(d) for d, _ in out.values()} == {
        "PNM", "XBM", "XPM"}
    for name, (data, held) in out.items():
        np.testing.assert_array_equal(image_io.decode_image(data), held,
                                      err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")), held,
            err_msg=name)
