"""The port's readers of the texture formats of model and game asset sets
(cge_tpu_torch/scene/sgi.py, pcx.py, qoi.py, ico.py, blp.py, ftex.py,
sun.py; the byte-serial parts in native/cge_raster.cpp; the dispatch in
Pillow's plugin order, scene/image_io.py) against Pillow, which the JAX
package's loader uses: seeded files Pillow writes (SGI raw at 8 and 16
bits, PCX in each mode it saves, QOI, ICO of bitmaps and of PNGs, BLP1 and
BLP2 palettes, bare DIBs), hand-made files of what Pillow does not write
(jax_references/make_textures.py: SGI run-length, PCX's 1-bit planes and
padded rows, DCX, CUR, FTEX, Sun raster of each depth, type and
run-length, BLP2 DXT1 / DXT3 / DXT5, BLP1 JPEG and palette), odd sizes,
random files (hypothesis), files cut at several lengths, the cases Pillow
refuses, and the dispatch where a format's test takes a file its plugin
cannot open. Pixels must be equal exactly (u8 / 255 as float32, as the JAX
loader gives them)."""

import io
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, mesh_io
from jax_references import make_textures as mt

# format -> the name its refusals carry
NAMES = {"sgi": "SGI", "pcx": "PCX", "dcx": "DCX", "qoi": "QOI",
         "ico": "ICO", "cur": "CUR", "blp": "BLP", "ftex": "FTEX",
         "sun": "Sun raster", "dib": "DIB"}


def _name_of(case: str) -> str:
    """The format name a case's refusal carries, from its name's prefix."""
    return NAMES[case.split("_")[0].rstrip("12")]


def _sgi_rle(w: int, rows: list) -> bytes:
    """A one-channel run-length SGI file of rows (packet bytes each, the
    bottom row first)."""
    h = len(rows)
    head = struct.pack(">HBBHHHH", 474, 1, 1, 2, w, h, 1).ljust(512, b"\0")
    starts, at = [], 512 + 8 * h
    for r in rows:
        starts.append(at)
        at += len(r)
    return (head + struct.pack(f">{h}I", *starts)
            + struct.pack(f">{h}I", *map(len, rows)) + b"".join(rows))


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _write(tmp_path, data, name="texture.bin"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _same_as_jax(tmp_path, data, name="texture.bin"):
    """The port's pixels equal JAX's; where JAX's loader (Pillow) raises,
    the port raises a ValueError that names the file and the format of the
    file's first bytes (format_of). JAX's pixels, or None."""
    path = _write(tmp_path, data, name)
    try:
        want = _jax_u8(path)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match=image_io.format_of(data)) as e:
            mesh_io.load_image(path)
        assert path in str(e.value)
        return None
    np.testing.assert_array_equal(_port_u8(path), want)
    return want


def _image(rng, h, w, mode="RGB"):
    im = PIL.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if mode == "RGBA":
        im = im.convert("RGBA")
        im.putalpha(PIL.fromarray(rng.integers(0, 256, (h, w),
                                               dtype=np.uint8)))
        return im
    return im.convert(mode)


SIZES = [(1, 1), (9, 13), (5, 7), (3, 17), (16, 16), (2, 33)]


def _pillow_written():
    """(name, bytes) of each format Pillow writes, in each mode and size."""
    rng = np.random.default_rng(220)
    out = []
    for h, w in SIZES:
        for mode in ("L", "RGB", "RGBA"):
            for bpc in (1, 2):
                out.append((f"sgi_{mode}_{bpc * 8}bit_{h}x{w}", mt._pillow(
                    _image(rng, h, w, mode), "SGI", bpc=bpc)))
        for mode in ("1", "L", "P", "RGB"):
            out.append((f"pcx_{mode}_{h}x{w}", mt._pillow(
                _image(rng, h, w, mode), "PCX")))
        for mode in ("RGB", "RGBA"):
            out.append((f"qoi_{mode}_{h}x{w}", mt._pillow(
                _image(rng, h, w, mode), "QOI")))
        for version in ("BLP1", "BLP2"):
            out.append((f"blp_{version}_{h}x{w}", mt._pillow(
                _image(rng, h, w, "P"), "BLP", blp_version=version)))
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            out.append((f"dib_{mode}_{h}x{w}", mt._pillow(
                _image(rng, h, w, mode), "DIB")))
    for side, sizes in ((16, [(16, 16), (8, 8), (4, 4)]), (13, [(13, 13)]),
                        (48, [(48, 48), (32, 32), (16, 16)]), (1, [(1, 1)])):
        for mode in ("RGB", "RGBA", "P", "L", "1"):
            for fmt in ("bmp", "png"):
                out.append((f"ico_{fmt}_{mode}_{side}", mt._pillow(
                    _image(rng, side, side, mode), "ICO", sizes=sizes,
                    bitmap_format=fmt)))
    return out


def _dib_entry(rng, h, w, bits):
    if bits <= 8:
        pal = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        px = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    else:
        pal, px = None, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return mt.dib_bytes(px, bits, pal)


def _hand_made():
    """(name, bytes) of the files Pillow does not write."""
    rng = np.random.default_rng(221)
    out = []
    for h, w in SIZES:
        for z in (1, 3, 4):
            for bpc in (1, 2):
                px = rng.integers(0, 3, (h, w, z)) * (100 if bpc == 1 else
                                                      20000)
                px[0, 0] += 1          # a lone value: copies besides runs
                out.append((f"sgi_rle_{z}ch_{bpc * 8}bit_{h}x{w}",
                            mt.sgi_file(px, bpc, True, rng)))
        for planes in (2, 4):
            exact = (w + 7) // 8
            for given_stride in {exact, exact + exact % 2}:
                stride = exact if given_stride == exact else \
                    exact + exact % 2
                rows = rng.integers(0, 256, (h, planes * stride),
                                    dtype=np.uint8)
                out.append((f"pcx_1bit_{planes}planes_stride"
                            f"{given_stride}_{h}x{w}", mt.pcx_file(
                                w, h, 1, planes, rows, version=2,
                                palette16=rng.integers(0, 256, (16, 3)),
                                stride=given_stride)))
        # RGB planes whose rows Pillow reads padded (widths 1 and 3 keep the
        # padding in their green and blue planes)
        stride = w + w % 2
        out.append((f"pcx_rgb_padded_{h}x{w}", mt.pcx_file(
            w, h, 8, 3, rng.integers(0, 256, (h, 3 * stride),
                                     dtype=np.uint8), stride=stride + 2)))
        pages = [mt._pillow(_image(rng, h, w, m), "PCX") for m in ("P", "1")]
        out.append((f"dcx_{h}x{w}", mt.dcx_file(pages)))
        for bits in (1, 4, 8, 24, 32):
            small = _dib_entry(rng, max(1, h // 2), max(1, w // 2), bits)
            out.append((f"cur_{bits}bit_{h}x{w}", mt.icon_file(
                [(w // 2, h // 2, 0, bits, small),
                 (w, h, 0, bits, _dib_entry(rng, h, w, bits))],
                cursor=True)))
        body = mt.dxt_blocks(rng, ((w + 3) // 4) * ((h + 3) // 4), "DXT1")
        out.append((f"ftex_dxt1_{h}x{w}", mt.ftex_file(w, h, 0, body)))
        out.append((f"ftex_rgb_{h}x{w}", mt.ftex_file(
            w, h, 1, rng.integers(0, 256, w * h * 3,
                                  dtype=np.uint8).tobytes())))
        for depth in (1, 4, 8, 24, 32):
            for ftype in (1, 2, 3):
                rb = ((w * depth + 7) // 8 if ftype == 2 else
                      (w * depth + 15) // 16 * 2)
                rows = rng.integers(0, 3, (h, rb), dtype=np.uint8) * 0x40
                out.append((f"sun_{depth}bit_type{ftype}_{h}x{w}",
                            mt.sun_file(w, h, depth, rows, ftype)))
            if depth in (4, 8):
                pal = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
                out.append((f"sun_{depth}bit_colour_map_{h}x{w}",
                            mt.sun_file(w, h, depth, rng.integers(
                                0, 256, (h, (w * depth + 15) // 16 * 2),
                                dtype=np.uint8), 1, pal[:7])))
        bgra = rng.integers(0, 256, (256, 4), dtype=np.uint8)
        for kind, enc in (("DXT1", 0), ("DXT3", 1), ("DXT5", 7)):
            blocks = mt.dxt_blocks(rng, ((w + 3) // 4) * ((h + 3) // 4),
                                   kind)
            for alpha in (0, 1):
                out.append((f"blp2_{kind}_alpha{alpha}_{h}x{w}", mt.blp_file(
                    2, w, h, blocks, encoding=2, alpha=alpha,
                    alpha_encoding=enc, palette=bgra)))
        idx = rng.integers(0, 256, (h, w), dtype=np.uint8).tobytes()
        out.append((f"blp2_palette_{h}x{w}", mt.blp_file(
            2, w, h, idx, encoding=1, palette=bgra)))
        for enc in (4, 5):
            out.append((f"blp1_palette_enc{enc}_{h}x{w}", mt.blp_file(
                1, w, h, idx, encoding=enc, palette=bgra, alpha=enc - 4)))
        for mode in ("RGB", "L", "CMYK"):
            jpg = mt._pillow(_image(rng, h, w, mode), "JPEG", quality=85)
            out.append((f"blp1_jpeg_{mode}_{h}x{w}", mt.blp_file(
                1, w, h, jpg[100:], compression=0, jpeg_header=jpg[:100])))
    return out


PILLOW_WRITTEN = _pillow_written()
HAND_MADE = _hand_made()


@pytest.mark.parametrize("name,data", PILLOW_WRITTEN,
                         ids=[n for n, _ in PILLOW_WRITTEN])
def test_pillow_written_files_match_jax(tmp_path, name, data):
    """SGI (L, RGB, RGBA at 8 and 16 bits), PCX (1, L, P, RGB), QOI (RGB,
    RGBA), BLP1 and BLP2, bare DIBs (1, L, P, RGB, RGBA) of each size, ICO
    of bitmaps and of PNGs in each mode with several entries: JAX's pixels,
    and the format by the file's first bytes whatever its name."""
    _same_as_jax(tmp_path, data, "texture.png")
    assert image_io.format_of(data) == _name_of(name)


@pytest.mark.parametrize("name,data", HAND_MADE,
                         ids=[n for n, _ in HAND_MADE])
def test_hand_made_files_match_jax(tmp_path, name, data):
    """SGI run-length (1, 3, 4 channels at 8 and 16 bits), PCX's 1-bit
    planes and padded RGB rows, DCX, CUR of each depth, FTEX DXT1 and raw,
    Sun raster of each depth in file types 1, 2 (run-length) and 3 and with
    colour maps, BLP2 DXT1 / DXT3 / DXT5 with and without alpha and palette,
    BLP1 palettes (encodings 4 and 5) and JPEG (RGB, grey, CMYK), each at
    1x1, 13x9, 7x5, 17x3, 16x16 and 33x2: JAX's pixels."""
    _same_as_jax(tmp_path, data)
    # a Sun raster one pixel wide may read as a GIMP brush first
    assert image_io.format_of(data) in (_name_of(name), "GBR")


def test_blp1_cmyk_jpeg_keeps_the_inverted_reading(tmp_path):
    """BlpImagePlugin sets a CMYK stream's decoder colour space to CMYK,
    which the stream already has, and keeps JpegImagePlugin's inverting raw
    mode: the pixels are the JPEG's own, read as BGR."""
    rng = np.random.default_rng(222)
    jpg = mt._pillow(_image(rng, 8, 8, "CMYK"), "JPEG", quality=90)
    data = mt.blp_file(1, 8, 8, jpg[50:], compression=0,
                       jpeg_header=jpg[:50])
    want = _same_as_jax(tmp_path, data)
    with PIL.open(io.BytesIO(jpg)) as im:
        np.testing.assert_array_equal(want,
                                      np.asarray(im.convert("RGB"))[..., ::-1])


@st.composite
def _random_pillow_files(draw):
    fmt = draw(st.sampled_from(["SGI", "PCX", "QOI", "ICO", "BLP", "DIB"]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    kw = {}
    if fmt == "SGI":
        mode = draw(st.sampled_from(["L", "RGB", "RGBA"]))
        kw["bpc"] = draw(st.sampled_from([1, 2]))
    elif fmt == "PCX":
        mode = draw(st.sampled_from(["1", "L", "P", "RGB"]))
    elif fmt == "QOI":
        mode = draw(st.sampled_from(["RGB", "RGBA"]))
    elif fmt == "DIB":
        mode = draw(st.sampled_from(["1", "L", "P", "RGB", "RGBA"]))
    elif fmt == "ICO":
        mode = draw(st.sampled_from(["RGB", "RGBA", "P", "L", "1"]))
        h = w
        kw["bitmap_format"] = draw(st.sampled_from(["bmp", "png"]))
        kw["sizes"] = [(w, w)] + [(s, s) for s in draw(st.lists(
            st.integers(1, w), max_size=3))]
    else:
        mode = "P"
        kw["blp_version"] = draw(st.sampled_from(["BLP1", "BLP2"]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    return fmt, mode, h, w, kw, seed


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=_random_pillow_files())
def test_random_pillow_files_match_jax(tmp_path_factory, case):
    """Random images Pillow saves as SGI, PCX, QOI, ICO, BLP or DIB in
    random modes and sizes decode to JAX's pixels."""
    fmt, mode, h, w, kw, seed = case
    rng = np.random.default_rng(seed)
    data = mt._pillow(_image(rng, h, w, mode), fmt, **kw)
    _same_as_jax(tmp_path_factory.mktemp("random"), data)


def _cuts(data: bytes) -> list:
    n = len(data)
    return sorted({3, 8, 13, 24, 40, 100, 300, 1100, n // 3, n // 2,
                   2 * n // 3, n - 2, n - 1} & set(range(1, n)))


# every Pillow-written and hand-made case at 9x13, and the 16x16 icons
DAMAGED = [(f"{name}@{cut}", data[:cut])
           for name, data in PILLOW_WRITTEN + HAND_MADE
           if name.endswith(("_9x13", "_16")) for cut in _cuts(data)]


@pytest.mark.parametrize("name,data", DAMAGED, ids=[n for n, _ in DAMAGED])
def test_damaged_files_match_jax(tmp_path, name, data):
    """Each format's files cut at several lengths, from inside the header
    to the last byte: where Pillow returns pixels (a raw row's padding, an
    SGI image that ends early, a DCX page table, an icon's unread bytes),
    the port returns the same; where Pillow raises, the port raises a
    ValueError that names the file and the format."""
    _same_as_jax(tmp_path, data)


def _blp2(encoding=1, alpha_encoding=0, compression=1):
    return mt.blp_file(2, 4, 4, bytes(16), encoding=encoding,
                       alpha_encoding=alpha_encoding,
                       compression=compression)


@pytest.mark.parametrize("kind,make,words", [
    ("blp2_encoding3", lambda: _blp2(encoding=3),
     r"BLP2.*encoding 3.*Unknown BLP encoding"),
    ("blp2_jpeg", lambda: _blp2(compression=0), r"BLP2 of compression 0"),
    ("blp2_alpha_encoding", lambda: _blp2(encoding=2, alpha_encoding=3),
     r"BLP2.*alpha encoding 3"),
    ("blp1_encoding3", lambda: mt.blp_file(1, 4, 4, bytes(16), encoding=3),
     r"BLP1.*encodings 4 and 5"),
    ("blp1_compression2", lambda: mt.blp_file(
        1, 4, 4, bytes(16), compression=2, encoding=5), r"BLP1.*compression"),
    ("blp1_short_palette", lambda: mt.blp_file(
        1, 4, 4, bytes(16), encoding=5)[:400], r"BLP palette is truncated"),
    ("blp_too_few_pixels", lambda: mt.blp_file(2, 4, 4, bytes(15)),
     r"BLP2.*not enough image data"),
    ("sgi_zsize2", lambda: mt.sgi_file(np.zeros((2, 2, 2), np.uint8), 1),
     r"SGI of 2 channels"),
    ("sgi_bpc3", lambda: mt.sgi_file(np.zeros((2, 2, 1), np.uint8), 1)
     .replace(b"\x01\xda\x00\x01", b"\x01\xda\x00\x03", 1),
     r"24-bit SGI.*not a mode"),
    ("sgi_dimension3_grey", lambda: mt.sgi_file(
        np.zeros((2, 2, 1), np.uint8), 1, dim=3), r"SGI.*dimension 3"),
    ("sgi_compression2", lambda: mt.sgi_file(np.zeros((2, 2, 1), np.uint8))
     .replace(b"\x01\xda\x00", b"\x01\xda\x02", 1), r"SGI.*compression 2"),
    ("sgi_rle_overrun", lambda: _sgi_rle(2, [b"\x03\x07\x00",
                                             b"\x02\x07\x00"]),
     r"SGI.*overrun"),
    ("ftex_two_formats", lambda: mt.ftex_file(4, 4, 1, bytes(48), count=2),
     r"FTEX with 2 formats"),
    ("ftex_no_formats", lambda: mt.ftex_file(4, 4, 1, bytes(48), count=0),
     r"FTEX with 0 formats"),
    ("ftex_format2", lambda: mt.ftex_file(4, 4, 2, bytes(48)),
     r"FTEX of format 2"),
    ("pcx_8bit_2planes", lambda: mt.pcx_file(
        2, 2, 8, 2, np.zeros((2, 4), np.uint8)), r"PCX.*8 bits in 2 planes"),
    ("pcx_version2_8bit", lambda: mt.pcx_file(
        2, 2, 8, 3, np.zeros((2, 6), np.uint8), version=2),
     r"PCX version 2 of 8 bits in 3 planes"),
    ("pcx_grey_short_file", lambda: mt.pcx_file(
        2, 2, 8, 1, np.zeros((2, 2), np.uint8)), r"PCX.*769 bytes"),
    ("pcx_run_past_row", lambda: mt.pcx_file(
        2, 2, 8, 3, np.zeros((2, 6), np.uint8)).replace(b"\xc6\x00",
                                                        b"\xc7\x00", 1),
     r"PCX.*crosses the end of a row"),
    ("sun_1bit_colour_map", lambda: mt.sun_file(
        8, 1, 1, np.zeros((1, 2), np.uint8), 1, np.zeros((2, 3))),
     r"1-bit Sun raster.*colour map"),
    ("sun_257_colours", lambda: mt.sun_file(
        2, 1, 8, np.zeros((1, 2), np.uint8), 1, np.zeros((257, 3))),
     r"Sun raster.*257 colours"),
    ("sun_rle_truncated", lambda: mt.sun_file(
        4, 2, 8, np.zeros((2, 4), np.uint8), 2)[:-1],
     r"Sun raster.*truncated"),
    ("qoi_stream_short", lambda: mt._pillow(
        PIL.new("RGB", (5, 5), 3), "QOI")[:-9], r"QOI.*truncated"),
    ("ico_and_mask_cut", lambda: mt.icon_file(
        [(4, 4, 0, 24, mt.dib_bytes(np.zeros((4, 4, 3), np.uint8), 24))])
     [:-4], r"ICO AND mask"),
    ("ico_32bit_alpha_cut", lambda: mt.icon_file(
        [(4, 4, 0, 32, mt.dib_bytes(np.zeros((4, 4, 3), np.uint8), 32,
                                    and_mask=False))])[:-1],
     r"ICO.*truncated"),
    ("ico_one_row", lambda: mt.icon_file(
        [(4, 1, 0, 24, mt.dib_bytes(np.zeros((1, 4, 3), np.uint8), 24)
          .replace(struct.pack("<i", 2), struct.pack("<i", 1), 1))]),
     r"ICO.*one row"),
    ("cur_jpeg_bitmap", lambda: mt.icon_file(
        [(4, 4, 0, 24, mt.dib_bytes(np.zeros((4, 4, 3), np.uint8), 24)
          .replace(struct.pack("<HI", 24, 0), struct.pack("<HI", 24, 4),
                   1))], cursor=True), r"CUR.*JPEG"),
    ("dcx_bad_page", lambda: mt.dcx_file([mt.pcx_file(
        2, 2, 8, 2, np.zeros((2, 4), np.uint8))]), r"DCX.*8 bits in 2"),
])
def test_refusals_name_their_format(tmp_path, kind, make, words):
    """What Pillow refuses raises a ValueError that names the format and
    the case (and JAX's loader raises too): BLP2's encoding 3 (raw BGRA),
    its JPEG compression and an unknown alpha encoding, BLP1's encodings
    other than 4 and 5 and compressions other than 0 and 1, a cut palette,
    too few pixels; SGI of 2 channels, 3 bytes a channel, grey at dimension
    3, compression 2, a run past its row; FTEX of 2 or 0 formats or format
    2; PCX modes Pillow has no reader for, an 8-bit grey file shorter than
    Pillow's palette seek, a run past its row; Sun raster colour maps on
    1-bit images or of 257 colours, cut run-length data; a short QOI
    stream; an icon's AND mask or alpha bytes cut, an icon entry of one
    row; a cursor's JPEG bitmap; a DCX page of an unknown mode."""
    path = _write(tmp_path, make())
    with pytest.raises(ValueError, match=words) as e:
        mesh_io.load_image(path)
    assert path in str(e.value)
    with pytest.raises(Exception):
        jax_image_io.load_image(path)


@pytest.mark.parametrize("kind,make,fmt", [
    # a Sun raster one pixel wide whose length field reads as a GIMP
    # brush's depth: GBR comes first in Pillow's order
    ("sun_as_gbr", lambda: mt.sun_file(1, 3, 8, np.ones((3, 2), np.uint8))
     .replace(struct.pack(">I", 6), struct.pack(">I", 4), 1), "GBR"),
    # the same width, another length: not a brush, so a Sun raster
    ("sun_not_gbr", lambda: mt.sun_file(1, 3, 8, np.ones((3, 2), np.uint8)),
     "Sun raster"),
    # a QOI image one pixel wide: GBR's test takes it, its header not
    ("qoi_width1", lambda: mt._pillow(PIL.new("RGB", (1, 4), 9), "QOI"),
     "QOI"),
    # one whose first index ops read as a brush's depth of 4
    ("qoi_width1_brush", lambda: b"qoif" + struct.pack(">II", 1, 4)
     + bytes((3, 0, 0, 0, 0, 0, 0, 4)), "GBR"),
    # a true-colour TGA starts with CUR's signature and no cursor
    ("tga_cur_signature", lambda: mt.tga_file(
        3, 2, 2, 24, bytes(range(18))), "CUR"),
    # an SGI file too short to open, then as nothing else
    ("sgi_header_only", lambda: b"\x01\xda\x00\x01\x00", "SGI"),
    # a DCX with no pages: Pillow's seek to the first raises, so it is no
    # DCX
    ("dcx_no_pages", lambda: struct.pack("<II", 987654321, 0), "DCX"),
])
def test_dispatch_follows_pillows_order(tmp_path, kind, make, fmt):
    """format_of names the first format whose test takes the file, in
    Pillow's order; where that format's header cannot be opened, the next
    one is tried, as Image.open does: the port decodes what JAX decodes and
    refuses what it refuses, naming the format."""
    data = make()
    assert image_io.format_of(data) == fmt
    path = _write(tmp_path, data)
    try:
        want = _jax_u8(path)
    except Exception:
        want = None
    if want is not None:
        np.testing.assert_array_equal(_port_u8(path), want)
    else:
        with pytest.raises(ValueError, match=fmt):
            mesh_io.load_image(path)


def test_not_opened_goes_on_to_the_next_format(tmp_path):
    """A header a format's test takes but its plugin cannot open raises
    native.NotOpened in the decoder, and decode_image tries the next
    format: a TGA that starts with CUR's signature decodes as TGA."""
    data = mt.tga_file(3, 2, 2, 24, bytes(range(18)))
    with pytest.raises(native.NotOpened):
        image_io.ico.decode_cur(data)
    _same_as_jax(tmp_path, data)


def test_loader_decodes_new_formats_without_pillow(tmp_path, monkeypatch):
    """The mesh loader's texture path with Pillow blocked: a file of every
    new format and kind decodes through image_io.format_of to JAX's
    pixels, computed before Pillow was blocked."""
    import builtins

    cases = [(n, d) for n, d in PILLOW_WRITTEN[::7] + HAND_MADE[::5]
             if image_io.format_of(d) != "GBR"]
    paths = [_write(tmp_path, data, f"{i}.tex")
             for i, (_, data) in enumerate(cases)]
    want = {}
    for p in paths:
        try:
            want[p] = _jax_u8(p)
        except Exception:
            want[p] = None
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    for p, (name, data) in zip(paths, cases):
        assert image_io.format_of(data) in image_io.READ
        if want[p] is None:                  # Pillow refuses it too
            with pytest.raises(ValueError, match=_name_of(name)):
                mesh_io.load_image(p)
        else:
            np.testing.assert_array_equal(_port_u8(p), want[p],
                                          err_msg=name)


def test_raster_library_against_python_twins():
    """native.pcx_rle, sun_rle and qoi against short Python twins of the
    PCX, Sun raster and QOI streams on seeded random data."""
    rng = np.random.default_rng(223)
    rows = rng.integers(0, 4, (6, 10), dtype=np.uint8) * 0x50
    np.testing.assert_array_equal(
        native.pcx_rle(mt.pcx_rle(rows), 0, 10, 6), rows)
    flat = (rng.integers(0, 3, 200, dtype=np.uint8) * 0x40).tobytes()
    np.testing.assert_array_equal(
        native.sun_rle(mt.sun_rle(flat), 0, 20, 10).reshape(-1),
        np.frombuffer(flat, np.uint8))
    px = rng.integers(0, 3, (9, 11, 4), dtype=np.uint8) * 60
    px[..., 3] = 255
    data = mt._pillow(PIL.fromarray(px, "RGBA"), "QOI")
    np.testing.assert_array_equal(native.qoi(data, 14, 99).reshape(9, 11, 4),
                                  px)
    with pytest.raises(ValueError, match="QOI op stream is truncated"):
        native.qoi(data[:20], 14, 99)


def test_fixtures_hold_each_new_format():
    """tests/torch_textures/ holds files of each new format, which
    chip_smoke.py's phase 18a decodes on the card's machine."""
    names = set(os.listdir(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "torch_textures")))
    for stem in ("sgi_", "pcx_", "dcx_", "qoi_", "ico_", "cur_", "blp1_",
                 "blp2_", "ftex_", "sun_"):
        assert any(n.startswith(stem) for n in names), stem
