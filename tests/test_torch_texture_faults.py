"""The four texture faults on which the port once parted from the JAX
package's loader (`cge_tpu.scene.image_io.load_image`, Pillow 12 on a path),
each held to it on files written to tmp_path, the same u8 pixels or both
raising (the port a ValueError naming the file and the format):

  1. Huffman JPEGs without an EOI whose data run to the end of the file:
     libjpeg's bit buffer reads ahead (57 bits a fill, six bytes at a time
     on its fast path, which it takes with 512 bytes a block of an MCU in
     hand of what Pillow has handed over in 64 KB blocks), and Pillow reads
     the file as truncated where a fill meets its end before the last MCU;
     a file of several scans needs its EOI (native/cge_jpeg.cpp).
  2. Damaged JPEG headers: Pillow's own walk of the markers in Python
     (JpegImagePlugin._open) before libjpeg's, and libjpeg's rules
     (segment lengths, DQT precision, standard Huffman tables for tables no
     DHT defined, a table's all-ones code only where a scan uses it).
  3. Damaged PNG chunks: the checks of PngImagePlugin's chunk handlers
     before the image data and after it, the data chunks that follow one
     another, an APNG's first frame (image_io._Png).
  4. Old-style JPEG TIFFs with damaged tables and JPEGInterchangeFormat
     (scene/ojpeg.py), and the restart failures libtiff meets there.
"""

import io
import json
import os
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch.scene import image_io, mesh_io, tiff
from jax_references import make_textures as mt

warnings.simplefilter("ignore", UserWarning)


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="t.tex", fmt=None):
    """The port's pixels equal JAX's, or both raise and the port's
    ValueError names the file and the format. JAX's pixels, or None."""
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


def _jpeg(px, **kw):
    return mt._pillow(PIL.fromarray(px), "JPEG", **kw)


# 1. Huffman JPEGs without an EOI

JPEG_KINDS = {"baseline_420": dict(quality=90),
              "baseline_444": dict(quality=80, subsampling=0),
              "restarts": dict(quality=85, restart_marker_blocks=3),
              "progressive": dict(quality=80, progressive=True),
              "grey": dict(quality=75)}


@pytest.mark.parametrize("kind", sorted(JPEG_KINDS))
def test_huffman_jpeg_without_eoi_follows_libjpeg_read_ahead(tmp_path, kind):
    """Files without their EOI and 0 to 11 bytes after the scan data (no
    marker among them): whether Pillow decodes one turns on libjpeg's
    read-ahead at the last MCUs; the port decides as it does. A
    progressive file (several scans) needs its EOI."""
    rng = np.random.default_rng(sorted(JPEG_KINDS).index(kind))
    decoded = 0
    for s in (8, 23, 61):
        px = mt.smooth_image(rng, s, s + 5, 30.0)
        if kind == "grey":
            px = px[..., 0]
        data = _jpeg(px, **JPEG_KINDS[kind])[:-2]
        for k in range(12):
            tail = rng.integers(1, 255, k, dtype=np.uint8).tobytes()
            decoded += _same_as_jax(tmp_path, data + tail, f"{s}_{k}.jpg",
                                    "JPEG") is not None
    if kind == "progressive":
        assert decoded == 0
    else:
        assert decoded > 0


@pytest.mark.parametrize("kind", ["baseline_420", "restarts", "progressive"])
@pytest.mark.parametrize("boundary", [1, 2])
def test_cuts_around_pillow_blocks_match_jax(tmp_path, kind, boundary):
    """A file of over 128 KB cut at lengths around Pillow's 64 KB block
    boundaries, where libjpeg suspends for the next block and decodes the
    MCU again (its fast path then open to it), and around its end."""
    rng = np.random.default_rng(boundary)
    px = mt.smooth_image(rng, 380, 380, 60.0)
    px = np.clip(px.astype(np.int32) + rng.integers(-40, 40, px.shape), 0,
                 255).astype(np.uint8)
    data = _jpeg(px, **{**JPEG_KINDS[kind], "quality": 95})
    assert len(data) > 2 * 65536
    ends = sorted(set(range(boundary * 65536 - 40, boundary * 65536 + 12, 3))
                  | set(range(len(data) - 30, len(data) - 1, 2)))
    for cut in ends:
        _same_as_jax(tmp_path, data[:cut], f"cut{cut}.jpg", "JPEG")


@pytest.mark.parametrize("seed", range(4))
def test_truncated_huffman_files_match_jax(tmp_path, seed):
    """Seeded files of each kind cut at a random point of their scan data
    or after it: Pillow refuses the ones libjpeg's reads run past, and
    decodes a single scan whose MCUs its buffer held."""
    rng = np.random.default_rng(400 + seed)
    for kind in sorted(JPEG_KINDS):
        px = mt.smooth_image(rng, int(rng.integers(8, 60)),
                             int(rng.integers(8, 60)), 25.0)
        if kind == "grey":
            px = px[..., 0]
        data = _jpeg(px, **JPEG_KINDS[kind])
        lo = data.find(b"\xff\xda") + 14
        for cut in sorted(set(rng.integers(lo, len(data), 6).tolist())):
            _same_as_jax(tmp_path, data[:cut], f"{kind}{cut}.jpg", "JPEG")


# 2. Damaged JPEG headers

def _segments(data):
    """The marker segments before the first scan: [(marker, offset,
    bytes)]."""
    out, pos = [], 2
    while True:
        m, n = data[pos + 1], struct.unpack_from(">H", data, pos + 2)[0]
        out.append((m, pos, data[pos:pos + 2 + n]))
        if m == 0xDA:
            return out
        pos += 2 + n


def _before_dqt(data, segment):
    at = data.index(b"\xff\xdb")
    return data[:at] + segment + data[at:]


def _header_case(case):
    px = mt.smooth_image(np.random.default_rng(7), 16, 24, 20.0)
    data = _jpeg(px, quality=85)
    segs = _segments(data)
    dqt = next(s for m, _, s in segs if m == 0xDB)
    if case == "tem_before_sos":
        return _before_dqt(data, b"\xff\x01")
    if case == "short_jfif":
        return data[:2] + b"\xff\xe0\x00\x07JFIF\x00" + data[20:]
    if case == "short_adobe":
        return _before_dqt(data, b"\xff\xee\x00\x08Adobe\x00")
    if case == "short_icc":
        return _before_dqt(data, b"\xff\xe2\x00\x0fICC_PROFILE\x00\x01")
    if case == "photoshop_cut_before_name":
        return _before_dqt(data, b"\xff\xed\x00\x18Photoshop 3.0\x008BIM"
                           b"\x03\xed")
    if case == "photoshop_resolution_cut":
        return _before_dqt(data, b"\xff\xed\x00\x23Photoshop 3.0\x008BIM"
                           b"\x03\xed\x00\x00\x00\x00\x00\x04abcd")
    if case == "com_length0":
        return _before_dqt(data, b"\xff\xfe\x00\x00")
    if case == "app_length1":
        return _before_dqt(data, b"\xff\xe5\x00\x01")
    if case == "dht_length1":
        return _before_dqt(data, b"\xff\xc4\x00\x01")
    if case == "dqt_precision2":
        wide = b"\xff\xdb\x00\x83\x20" + np.frombuffer(
            dqt[5:69], np.uint8).astype(">u2").tobytes()
        return data.replace(dqt, wide, 1)
    if case == "dqt_cut":
        return data.replace(dqt, b"\xff\xdb\x00\x40" + dqt[4:66], 1)
    if case == "dqt_long":
        return data.replace(dqt, b"\xff\xdb\x00\x44" + dqt[4:] + b"\0", 1)
    if case == "sof_long":
        sof = next(s for m, _, s in segs if m == 0xC0)
        return data.replace(sof, sof[:3] + bytes((sof[3] + 3,)) + sof[4:]
                            + b"\1\1\0", 1)
    if case == "sof_cut":
        sof = next(s for m, _, s in segs if m == 0xC0)
        return data.replace(sof, b"\xff\xc0\x00\x06" + sof[4:8], 1)
    if case == "dhp_before_sof":
        return _before_dqt(data, b"\xff\xde\x00\x08\x08\x00\x10\x00\x18\x01")
    if case == "std_tables":
        return b"".join([data[:2]] + [s for m, _, s in segs if m != 0xC4]
                        + [data[segs[-1][1] + len(segs[-1][2]):]])
    if case == "std_tables_progressive":
        prog = _jpeg(px, quality=85, progressive=True)
        psegs = _segments(prog)
        return b"".join([prog[:2]] + [s for m, _, s in psegs if m != 0xC4]
                        + [prog[psegs[-1][1] + len(psegs[-1][2]):]])
    if case == "unused_all_ones_code":
        return _before_dqt(data, b"\xff\xc4\x00\x15\x13\x02" + bytes(15)
                           + b"\x00\x01")
    if case == "used_all_ones_code":
        dht = next(s for m, _, s in segs if m == 0xC4)
        bad = dht[:5] + b"\x02" + bytes(15) + b"\x00\x01"
        return data.replace(dht, bad[:2] + struct.pack(">H", len(bad) - 2)
                            + bad[4:], 1)
    raise KeyError(case)


HEADER_CASES = ["tem_before_sos", "short_jfif", "short_adobe", "short_icc",
                "photoshop_cut_before_name", "photoshop_resolution_cut",
                "com_length0", "app_length1", "dht_length1",
                "dqt_precision2", "dqt_cut", "dqt_long", "sof_long",
                "sof_cut", "dhp_before_sof", "std_tables",
                "std_tables_progressive", "unused_all_ones_code",
                "used_all_ones_code"]


@pytest.mark.parametrize("case", HEADER_CASES)
def test_damaged_jpeg_headers_follow_pillow(tmp_path, case):
    """Each case of Pillow's marker walk and libjpeg's header rules: a TEM
    marker, JFIF, Adobe and ICC segments cut before what Pillow reads, a
    Photoshop resource cut before its name (IndexError) or its resolution
    (passed over), segment lengths below 2 (APPn and COM skip nothing,
    DHT fails), 16-bit DQT entries under precision 2, DQT and SOF segments
    of the wrong length, a DHP marker, the Huffman tables left out
    (libjpeg's standard ones in a sequential file, none in a progressive
    one), and an all-ones code in a table a scan uses or not."""
    _same_as_jax(tmp_path, _header_case(case), f"{case}.jpg", "JPEG")


def _damage_header(rng, data):
    """Bytes flipped, inserted or taken out before the end of the first
    SOS segment."""
    data = bytearray(data)
    sos = data.find(b"\xff\xda")
    hi = sos + 2 + (data[sos + 2] << 8 | data[sos + 3])
    mode = int(rng.integers(0, 3))
    k = int(rng.integers(2, hi))
    if mode == 0:
        for _ in range(int(rng.integers(1, 3))):
            data[int(rng.integers(2, hi))] ^= int(rng.integers(1, 256))
    elif mode == 1:
        data[k:k] = rng.integers(0, 256, int(rng.integers(1, 6)),
                                 dtype=np.uint8).tobytes()
    else:
        del data[k:k + int(rng.integers(1, 6))]
    return bytes(data)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_damaged_headers_match_jax(tmp_path, seed):
    """Seeded header damage over baseline, progressive, 4:4:4, restart and
    grey files: the port gives JAX's pixels or refuses where it refuses."""
    rng = np.random.default_rng(500 + seed)
    px = mt.smooth_image(rng, 24, 40, 20.0)
    files = [_jpeg(px, **kw) for kw in JPEG_KINDS.values()]
    for t in range(60):
        data = _damage_header(rng, files[t % len(files)])
        _same_as_jax(tmp_path, data, f"h{t}.jpg")


# 3. Damaged PNG chunks

def _png(chunks):
    return b"\x89PNG\r\n\x1a\n" + b"".join(mt._chunk(k, v) for k, v in chunks)


def _png_base(mode, seed=0):
    rng = np.random.default_rng(seed)
    im = PIL.fromarray(rng.integers(0, 256, (7, 10, 3), dtype=np.uint8))
    data = mt._pillow(im.convert(mode), "PNG")
    out, pos = [], 8
    while pos + 8 <= len(data):
        n, k = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((k, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _fctl(seq, w, h, x, y):
    return (b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, x, y, 1, 10, 0, 0))


Z = zlib.compress(b"text")
PNG_EXTRA = {
    "iccp_method1": (b"iCCP", b"p\x00\x01" + Z),
    "iccp_empty": (b"iCCP", b""),
    "iccp_no_method": (b"iCCP", b"name\x00"),
    "iccp_not_zlib": (b"iCCP", b"p\x00\x00garbage"),
    "ztxt_method1": (b"zTXt", b"k\x00\x01" + Z),
    "ztxt_key_only": (b"zTXt", b"k"),
    "ztxt_too_large": (b"zTXt", b"k\x00\x00" + zlib.compress(
        b"a" * (1 << 21))),
    "itxt_flag_method1": (b"iTXt", b"k\x00\x01\x01en\x00t\x00" + Z),
    "itxt_not_zlib": (b"iTXt", b"k\x00\x01\x00en\x00t\x00junk"),
    "itxt_cut": (b"iTXt", b"k\x00\x01"),
    "itxt_too_large": (b"iTXt", b"k\x00\x01\x00en\x00t\x00" + zlib.compress(
        b"a" * (1 << 21))),
    "gama_short": (b"gAMA", b"\x00\x01"),
    "chrm_31": (b"cHRM", bytes(31)),
    "srgb_empty": (b"sRGB", b""),
    "phys_8": (b"pHYs", bytes(8)),
    "trns_1": (b"tRNS", b"\x00"),
    "trns_4": (b"tRNS", bytes(4)),
    "actl_short": (b"acTL", bytes(3)),
    "actl_zero": (b"acTL", bytes(8)),
    "plte_in_grey": (b"PLTE", bytes(range(48))),
    "fdat_first": (b"fdAT", b"\x00\x00\x00\x00"),
}


@pytest.mark.parametrize("where", ["before", "after"])
@pytest.mark.parametrize("case", sorted(PNG_EXTRA))
@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_png_chunk_handlers_follow_pillow(tmp_path, mode, case, where):
    """Each handler check of Pillow's PngStream on a chunk before the
    image data (its _open: CRCs checked, SyntaxError, IndexError or
    struct.error there make the file unopenable) and after it (load_end:
    the same handlers, whose errors raise)."""
    chunks = _png_base(mode)
    at = next(i for i, (k, _) in enumerate(chunks) if k == b"IDAT")
    chunks.insert(at if where == "before" else at + 1, PNG_EXTRA[case])
    _same_as_jax(tmp_path, _png(chunks), f"{case}.png", "PNG")


@pytest.mark.parametrize("frame", [(0, 10, 7, 0, 0), (0, 4, 3, 2, 1),
                                   (0, 10, 7, 1, 0), (1, 10, 7, 0, 0),
                                   (0, 0, 7, 0, 0), (0, 11, 7, 0, 0)])
@pytest.mark.parametrize("actl", [None, 1, 2])
def test_apng_first_frame_follows_pillow(tmp_path, frame, actl):
    """An fcTL before the image data: its sequence number and bounds
    checked (SyntaxError), its frame the image data's region in an image
    of zeros, with or without an acTL (1 or 2 frames)."""
    seq, w, h, x, y = frame
    rng = np.random.default_rng(w * 10 + h)
    px = rng.integers(0, 256, (max(h, 1), max(w, 1), 3), dtype=np.uint8)
    idat = zlib.compress(mt._filter_rows(px.reshape(len(px), -1), 3, (1,)))
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", 10, 7, 8, 2, 0, 0, 0))]
    if actl:
        chunks.append((b"acTL", struct.pack(">II", actl, 0)))
    chunks += [_fctl(seq, w, h, x, y), (b"IDAT", idat),
               _fctl(seq + 1, 3, 3, 0, 0), (b"IEND", b"")]
    _same_as_jax(tmp_path, _png(chunks), "a.png", "PNG")


@pytest.mark.parametrize("case", ["plte_after_idat", "no_plte",
                                  "plte_before_ihdr", "idat_split_by_text",
                                  "second_ihdr_after_idat", "interlace2",
                                  "trailing_chunk_cut", "crc_bad_after"])
def test_png_chunk_order_follows_pillow(tmp_path, case):
    """The chunk order as Pillow reads it: a PLTE only before the image
    data and after the IHDR counts (no palette: black), the image data
    from the data chunks that follow one another, an IHDR after the data
    ignored, interlace methods past 1 read as Adam7, a chunk after the data
    cut short raising, CRCs after the data not checked."""
    rng = np.random.default_rng(3)
    ind = rng.integers(0, 8, (6, 9), dtype=np.uint8)
    raw = mt._filter_rows(ind, 1, (0, 2))
    ihdr = (b"IHDR", struct.pack(">IIBBBBB", 9, 6, 8, 3, 0, 0, 0))
    plte = (b"PLTE", rng.integers(0, 256, 24, dtype=np.uint8).tobytes())
    z = zlib.compress(raw)
    chunks = {
        "plte_after_idat": [ihdr, (b"IDAT", z), plte],
        "no_plte": [ihdr, (b"IDAT", z)],
        "plte_before_ihdr": [plte, ihdr, (b"IDAT", z)],
        "idat_split_by_text": [ihdr, plte, (b"IDAT", z[:10]),
                               (b"tEXt", b"a\0b"), (b"IDAT", z[10:])],
        "second_ihdr_after_idat": [ihdr, plte, (b"IDAT", z), (
            b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0))],
        "interlace2": [],
        "trailing_chunk_cut": [ihdr, plte, (b"IDAT", z)],
        "crc_bad_after": [ihdr, plte, (b"IDAT", z), (b"tEXt", b"a\0b")],
    }[case]
    data = _png(chunks + [(b"IEND", b"")])
    if case == "interlace2":
        full = mt.png_file(ind[..., None], 8, 3, True, np.frombuffer(
            plte[1], np.uint8).reshape(-1, 3))
        data = full[:28] + b"\x02" + struct.pack(">I", zlib.crc32(
            full[12:28] + b"\x02")) + full[33:]
    if case == "trailing_chunk_cut":
        data = data[:-12] + mt._chunk(b"tEXt", b"abc=def")[:9]
    if case == "crc_bad_after":
        data = data.replace(mt._chunk(b"tEXt", b"a\0b"),
                            mt._chunk(b"tEXt", b"a\0b")[:-1] + b"!")
    _same_as_jax(tmp_path, data, f"{case}.png", "PNG")


@pytest.mark.parametrize("seed", range(4))
def test_seeded_chunk_damage_matches_jax(tmp_path, seed):
    """Seeded chunks of every handler inserted before and after the image
    data of PNGs of each mode, fcTL frames of random bounds, and PLTEs in
    random places: the port gives JAX's pixels, or both raise."""
    rng = np.random.default_rng(600 + seed)
    extras = list(PNG_EXTRA.values())
    for t in range(50):
        chunks = _png_base(["RGB", "L", "P", "1", "RGBA", "LA"][t % 6], t)
        at = next(i for i, (k, _) in enumerate(chunks) if k == b"IDAT")
        for _ in range(int(rng.integers(1, 3))):
            chunks.insert(int(rng.integers(1, at + 1)) if rng.random() < 0.7
                          else len(chunks) - 1,
                          extras[int(rng.integers(0, len(extras)))])
        if rng.random() < 0.3:
            at = next(i for i, (k, _) in enumerate(chunks) if k == b"IDAT")
            chunks.insert(at, _fctl(int(rng.integers(0, 2)),
                                    int(rng.integers(0, 12)),
                                    int(rng.integers(0, 9)),
                                    int(rng.integers(0, 3)),
                                    int(rng.integers(0, 3))))
        _same_as_jax(tmp_path, _png(chunks), f"p{t}.png", "PNG")


# 4. Old-style JPEG TIFFs with damaged tables

def _entries(data):
    order = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack_from(order + "I", data, 4)[0]
    n = struct.unpack_from(order + "H", data, ifd)[0]
    return {struct.unpack_from(order + "H", data, ifd + 2 + 12 * i)[0]:
            ifd + 2 + 12 * i for i in range(n)}


def _ojpeg_files(rng):
    px = mt.smooth_image(rng, 24, 24, 25.0)
    return [mt.ojpeg_tiff(px[..., :1], 1, form="jif", rows_per_strip=8),
            mt.ojpeg_tiff(px[..., :1], 1, form="jif", jif_length=False),
            mt.ojpeg_tiff(px, 6, subsampling=2, form="tables",
                          rows_per_strip=16),
            mt.ojpeg_tiff(px[..., :1], 1, form="tables"),
            mt.ojpeg_tiff(px, 6, subsampling=0, form="jif",
                          rows_per_strip=8),
            mt.ojpeg_tiff(px, 6, subsampling=0, form="tables", restart=2)]


@pytest.mark.parametrize("seed", range(3))
def test_ojpeg_damaged_tables_match_jax(tmp_path, seed):
    """Bytes changed in JPEGQTables, JPEGDCTables and JPEGACTables and in
    the JPEGInterchangeFormat header of old-style JPEG TIFFs in each form:
    the port gives Pillow's pixels or raises where it raises."""
    rng = np.random.default_rng(700 + seed)
    for i, data in enumerate(_ojpeg_files(rng)):
        tags = tiff._ifd(data)[2]
        regions = []
        if 513 in tags:
            off = tiff._list(tags[513])[0]
            regions.append((off, off + (tiff._list(tags.get(514, (0,)))[0]
                                        or 300)))
        for t, size in ((519, 64), (520, 28), (521, 178)):
            for off in tiff._list(tags.get(t, ())):
                regions.append((off, off + size))
        for k in range(20):
            lo, hi = regions[int(rng.integers(0, len(regions)))]
            b = bytearray(data)
            for pos in rng.integers(lo, hi, 1 + k % 3):
                b[pos] = int(rng.integers(0, 256))
            _same_as_jax(tmp_path, bytes(b), f"t{i}_{k}.tif", "TIFF")


@pytest.mark.parametrize("seed", range(3))
def test_ojpeg_damaged_table_tags_match_jax(tmp_path, seed):
    """The tags of the tables and of JPEGInterchangeFormat damaged: their
    values moved or anywhere in the file, their counts changed (more than
    3 offsets: libtiff leaves the tag unset), their types changed to other
    integer, rational and undefined ones (libtiff reads integers of any
    width and leaves the others unset), JPEGRestartInterval out of range."""
    rng = np.random.default_rng(800 + seed)
    for i, data in enumerate(_ojpeg_files(rng)):
        ent = _entries(data)
        tags = [t for t in (513, 514, 515, 519, 520, 521) if t in ent]
        for k in range(24):
            b = bytearray(data)
            e = ent[tags[int(rng.integers(0, len(tags)))]]
            typ, cnt, val = struct.unpack_from("<HII", b, e + 2)
            mode = k % 4
            if mode == 0:
                struct.pack_into("<I", b, e + 8,
                                 int(rng.integers(0, len(data) + 50)))
            elif mode == 1:
                struct.pack_into("<I", b, e + 8,
                                 max(0, val + int(rng.integers(-40, 40))))
            elif mode == 2:
                struct.pack_into("<I", b, e + 4,
                                 max(0, cnt + int(rng.integers(-2, 3))))
            else:
                struct.pack_into("<H", b, e + 2,
                                 int(rng.choice([1, 3, 4, 5, 6, 7, 8, 9])))
            _same_as_jax(tmp_path, bytes(b), f"g{i}_{k}.tif", "TIFF")


def test_ojpeg_jif_length_ends_the_sos_skip(tmp_path):
    """A JPEGInterchangeFormatLength that cuts the SOS segment's last
    bytes: libtiff's skip of Ss, Se, Ah and Al stops at the end of that
    block and reads none of the first strip's bytes."""
    px = mt.smooth_image(np.random.default_rng(9), 24, 24, 25.0)
    data = mt.ojpeg_tiff(px, 6, subsampling=0, form="jif", rows_per_strip=8)
    e = _entries(data)[514]
    n = struct.unpack_from("<I", data, e + 8)[0]
    for cut in range(1, 4):
        b = bytearray(data)
        struct.pack_into("<I", b, e + 8, n - cut)
        assert _same_as_jax(tmp_path, bytes(b), f"c{cut}.tif") is not None


def _with_bad_restart(data, k):
    """The strips of an old-style JPEG TIFF with b"\\xff\\xd5" (a restart
    marker out of place) after strip k's data, the offsets moved on."""
    order = "<" if data[:2] == b"II" else ">"
    tags = tiff._ifd(data)[2]
    offs = list(tiff._list(tags[273]))
    counts = list(tiff._list(tags[279]))
    end = offs[k] + counts[k]
    b = bytearray(data[:end] + b"\xff\xd5" + data[end:])
    ifd = struct.unpack_from(order + "I", b, 4)[0]
    if ifd >= end:
        ifd += 2
        struct.pack_into(order + "I", b, 4, ifd)
    for i in range(struct.unpack_from(order + "H", b, ifd)[0]):
        e = ifd + 2 + 12 * i
        tag, typ, cnt = struct.unpack_from(order + "HHI", b, e)
        at = e + 8
        if {3: 2, 4: 4}.get(typ, 1) * cnt > 4:
            v = struct.unpack_from(order + "I", b, at)[0]
            if v >= end:
                v += 2
                struct.pack_into(order + "I", b, at, v)
            at = v
        if tag == 273:
            for j in range(cnt):
                o = struct.unpack_from(order + "I", b, at + 4 * j)[0]
                if o >= end:
                    struct.pack_into(order + "I", b, at + 4 * j, o + 2)
        elif tag == 279:
            struct.pack_into(order + "I", b, at + 4 * k, counts[k] + 2)
    return bytes(b)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("sampling", [0, 1, 2, "grey"])
def test_ojpeg_restart_failure_before_a_later_strip(tmp_path, order,
                                                    sampling):
    """A restart marker out of place after each strip: libtiff's source
    fails at it; Pillow's RGBA path reads the failing strip as zeros where
    it is the last, and fails where another strip follows (its skip calls
    libjpeg again), or where a skip meets the failure (big-endian files);
    grey fails."""
    px = mt.smooth_image(np.random.default_rng(11), 40, 24, 25.0)
    grey = sampling == "grey"
    rps = 16 if sampling == 2 else 8
    data = mt.ojpeg_tiff(px[..., :1] if grey else px, 1 if grey else 6,
                         subsampling=0 if grey else sampling,
                         rows_per_strip=rps, order=order)
    strips = len(tiff._list(tiff._ifd(data)[2][273]))
    for k in range(strips - 1):
        _same_as_jax(tmp_path, _with_bad_restart(data, k), f"r{k}.tif",
                     "TIFF")


def test_ojpeg_frame_taller_than_the_image(tmp_path):
    """A frame header taller than the image whose restart fails below the
    lines libtiff reads: Pillow never decodes that far, and the port
    decodes the image as it does."""
    px = mt.smooth_image(np.random.default_rng(12), 24, 24, 25.0)
    data = mt.ojpeg_tiff(px[..., :1], 1, form="jif", restart=3)
    sof = data.index(b"\xff\xc0")
    taller = data[:sof + 5] + struct.pack(">H", 152) + data[sof + 7:]
    assert _same_as_jax(tmp_path, taller) is not None


def test_ojpeg_table_offset_past_the_file_is_refused(tmp_path):
    """A JPEGQTables offset given as an 8-byte value in a classic TIFF, far
    past the file's end: libtiff's seek there fails (past the file
    system's largest offset) and it reads the table from wherever the file
    stood, so Pillow's pixels depend on that position (a standing record,
    ROADMAP section 3); the port refuses the file, naming the case."""
    px = mt.smooth_image(np.random.default_rng(13), 16, 16, 25.0)
    data = bytearray(mt.ojpeg_tiff(px[..., :1], 1, form="tables"))
    struct.pack_into("<H", data, _entries(bytes(data))[519] + 2, 16)
    path = str(tmp_path / "far.tif")
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="JPEGQTables past the end") as e:
        mesh_io.load_image(path)
    assert path in str(e.value)


def test_fault_fixtures_match_pillow_in_memory():
    """The JPEG and PNG fault fixtures (tests/torch_textures/x11_pnm/)
    decode through image_io.decode_image to the pixels Pillow gives from
    their bytes in memory too (for these formats the same reader as the
    file's)."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_textures", "x11_pnm")
    manifest = json.load(open(os.path.join(folder, "manifest.json")))
    kinds = {"jpeg_no_eoi", "jpeg_header", "png_chunks"}
    for e in manifest["files"]:
        if e["kind"] not in kinds:
            continue
        data = open(os.path.join(folder, e["name"]), "rb").read()
        want = np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(image_io.decode_image(data), want)
