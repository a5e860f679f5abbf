"""The TIFF cases the port reads since its tail was ported, against Pillow
12 (libtiff 4.7), which the JAX package's loader uses: old-style JPEG
(compression 6, cge_tpu_torch/scene/ojpeg.py and native/cge_jpeg.cpp's raw
data) in each form libtiff reads (a stream in the strips, a
JPEGInterchangeFormat header, tables in tags), grey and YCbCr at each
sampling, with restarts, several strips and odd sizes; ThunderScan
(32809, native/cge_raster.cpp) with each code kind, odd widths and
strips; JPEG YCbCr in separate planes; the refusals Pillow makes too
(SGILog, WebP in TIFF, damaged streams). Also every fixture of
tests/torch_textures/pillow_tail/ and tail_chip/ (make_textures
tail_fixtures and tail_chip_files: these cases, JPEG 2000 Part 2 and Lab)
against JAX's `load_image` and its manifest's hash. Pixels must be equal
exactly; where Pillow refuses a file, the port raises a ValueError."""

import hashlib
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, mesh_io, ojpeg, tiff
from jax_references import make_textures as mt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_textures")
MANIFESTS = {}
for _d in ("pillow_tail", "tail_chip"):
    with open(os.path.join(FIXTURES, _d, "manifest.json")) as _f:
        MANIFESTS[_d] = json.load(_f)
ENTRIES = [(d, e["name"]) for d, m in MANIFESTS.items() for e in m["files"]]


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="t.tif"):
    """The port's pixels equal JAX's, or both raise (the port a
    ValueError naming TIFF). JAX's pixels, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = _jax_u8(path)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="TIFF"):
            mesh_io.load_image(path)
        return None
    np.testing.assert_array_equal(_port_u8(path), want)
    return want


@pytest.mark.parametrize("folder,name", ENTRIES,
                         ids=[n for _, n in ENTRIES])
def test_tail_fixtures_match_jax(folder, name):
    """Each fixture: the port's pixels equal JAX's and the manifest's hash
    (what chip_smoke.py's phase 18a checks on the card's machine)."""
    entry = next(e for e in MANIFESTS[folder]["files"] if e["name"] == name)
    path = os.path.join(FIXTURES, folder, name)
    got = _port_u8(path)
    assert list(got.shape) == entry["shape"]
    np.testing.assert_array_equal(got, _jax_u8(path))
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_tail_manifests_hold_each_case():
    """pillow_tail/ holds each form of old-style JPEG, ThunderScan, JPEG
    YCbCr planes, Lab TIFF and PSD and the JPEG 2000 Part 2 markers;
    tail_chip/ the chip path's three files, under 1 MB."""
    names = {n for _, n in ENTRIES}
    for stem in ("tiff_ojpeg_grey_stream", "tiff_ojpeg_grey_jif",
                 "tiff_ojpeg_grey_tables", "tiff_ojpeg_ycbcr22_stream",
                 "tiff_ojpeg_ycbcr11_tables", "tiff_ojpeg_ycbcr21_tables",
                 "tiff_ojpeg_rgb_as_ycbcr", "tiff_thunderscan_",
                 "tiff_jpeg_ycbcr_planes", "tiff_lab_ii", "tiff_lab_mm",
                 "psd_lab_raw", "psd_lab_packbits", "j2k_part2_mct_offsets_",
                 "j2k_part2_deco3x3", "j2k_part2_mcc_mco", "j2k_part2_cbd",
                 "j2k_part2_atk_ads", "j2k_part2_opj_mct3x3",
                 "j2k_part2_opj_mct4x4", "j2k_part2_mco_in_tile",
                 "jp2_part2_"):
        assert any(n.startswith(stem) for n in names), stem
    chip = MANIFESTS["tail_chip"]["files"]
    assert {e["name"] for e in chip} == {mt.TAIL_LAB, mt.TAIL_MCT,
                                         mt.TAIL_OJPEG}
    assert sum(e["bytes"] for e in chip) < 1 << 20


# ------------------------------------------------------------ old-style JPEG

OJPEG_CASES = {
    "grey_stream": dict(photometric=1),
    "grey_miniswhite_stream": dict(photometric=0),
    "grey_jif_strips": dict(photometric=1, form="jif", rows_per_strip=8),
    "grey_jif_no_length": dict(photometric=1, form="jif", jif_length=False),
    "grey_tables": dict(photometric=1, form="tables"),
    "grey_tables_restart": dict(photometric=1, form="tables", restart=2),
    "grey_tables_strips": dict(photometric=1, form="tables",
                               rows_per_strip=8),
    "ycbcr11_stream": dict(photometric=6, subsampling=0),
    "ycbcr21_jif": dict(photometric=6, subsampling=1, form="jif"),
    "ycbcr22_stream": dict(photometric=6, subsampling=2),
    "ycbcr22_jif_strips": dict(photometric=6, subsampling=2, form="jif",
                               rows_per_strip=16),
    "ycbcr22_tables_restart": dict(photometric=6, subsampling=2,
                                   form="tables", restart=3),
    "ycbcr11_tables_strips": dict(photometric=6, subsampling=0,
                                  form="tables", rows_per_strip=8),
    "rgb_photometric_tables": dict(photometric=2, subsampling=1,
                                   form="tables"),
    "mm_ycbcr22_jif": dict(photometric=6, subsampling=2, form="jif",
                           order=">"),
    "mm_grey_stream_strips": dict(photometric=1, rows_per_strip=8,
                                  order=">"),
    "mm_ycbcr11_tables_strips": dict(photometric=6, subsampling=0,
                                     form="tables", rows_per_strip=8,
                                     order=">"),
    "mm_ycbcr22_jif_strips": dict(photometric=6, subsampling=2, form="jif",
                                  rows_per_strip=16, order=">"),
}


@pytest.mark.parametrize("size", [(16, 16), (13, 11), (32, 40), (24, 17)])
@pytest.mark.parametrize("case", sorted(OJPEG_CASES))
def test_ojpeg_matches_jax(tmp_path, case, size):
    """Old-style JPEG of a seeded image in each form libtiff reads: a
    stream in the strips (from SOI; a strip that is a whole JFIF file), a
    JPEGInterchangeFormat header with the scan data in the strips (with and
    without its Length), tables from JPEGQTables / DCTables / ACTables;
    grey, YCbCr 1x1, 2x1 and 2x2 through the RGBA path (photometric RGB
    taken as YCbCr); restart markers inside a strip and put back between
    strips; II and MM (where libtiff, its post-decode step replaced in a
    file of swapped bytes, skips a strip before each strip after the first:
    ojpeg.strip_lines); sizes that are and are not whole MCUs."""
    kw = OJPEG_CASES[case]
    h, w = size
    rng = np.random.default_rng(sum(map(ord, case)) + h * w)
    px = mt.smooth_image(rng, h, w, 25.0)
    if kw["photometric"] in (0, 1):
        px = px[..., :1]
    want = _same_as_jax(tmp_path, mt.ojpeg_tiff(px, quality=75, **kw))
    if case != "grey_jif_no_length":
        assert want is not None


def test_ojpeg_damaged_scan_data_match_jax(tmp_path):
    """Old-style JPEG files whose scan data (the strips' bytes) are zeroed
    from a point on or have bytes changed: the port gives Pillow's pixels
    or raises where Pillow raises. libtiff's source fails where libjpeg
    would resynchronise at a restart marker: grey then raises, and YCbCr
    (the RGBA path) reads as zeros from the strip that failed on, which
    libtiff clears. (Damaged tables in tags are not held to Pillow: there
    Pillow's file reader raises where its reader of bytes in memory gives
    pixels.)"""
    rng = np.random.default_rng(61)
    px = mt.smooth_image(rng, 24, 24, 25.0)
    files = [mt.ojpeg_tiff(px[..., :1], 1, form="jif", rows_per_strip=8),
             mt.ojpeg_tiff(px, 6, subsampling=2, form="tables",
                           rows_per_strip=16),
             mt.ojpeg_tiff(px, 6, subsampling=1, restart=2),
             mt.ojpeg_tiff(px, 6, subsampling=0, form="jif",
                           rows_per_strip=8)]
    for i, data in enumerate(files):
        ifd = struct.unpack_from("<I", data, 4)[0]
        start = min(tiff._list(tiff._ifd(data)[2][273]))
        for cut in sorted(set(rng.integers(start, ifd, 6).tolist())):
            _same_as_jax(tmp_path, data[:cut] + bytes(ifd - cut)
                         + data[ifd:], f"cut{i}_{cut}.tif")
        for k in range(12):
            b = bytearray(data)
            for pos in rng.integers(start, ifd, 1 + k % 2):
                b[pos] = int(rng.integers(0, 256))
            _same_as_jax(tmp_path, bytes(b), f"flip{i}_{k}.tif")


def test_ojpeg_refusals_name_their_case(tmp_path):
    """What libtiff's OJPEG codec refuses raises, as in Pillow: a frame
    narrower than the image, a strip height that is no whole number of MCU
    rows, missing tables; and a file of one tile, its stream a whole JFIF
    file, decodes as in Pillow (tiles are ported)."""
    rng = np.random.default_rng(62)
    px = mt.smooth_image(rng, 16, 16, 25.0)
    narrow = mt.ojpeg_tiff(px, 6, subsampling=2)
    narrow = narrow.replace(struct.pack("<HHII", 256, 4, 1, 16),
                            struct.pack("<HHII", 256, 4, 1, 24))
    no_tables = mt.ojpeg_tiff(px[..., :1], 1, form="tables").replace(
        struct.pack("<HH", 519, 4), struct.pack("<HH", 50519 % 65536, 4))
    cases = [(narrow, r"width"), (no_tables, r"Missing JPEG tables"),
             (mt.ojpeg_tiff(px[..., :1], 1, rows_per_strip=8).replace(
                 struct.pack("<HHII", 278, 4, 1, 8),
                 struct.pack("<HHII", 278, 4, 1, 4)), r"JPEG")]
    for k, (data, words) in enumerate(cases):
        path = tmp_path / f"refused{k}.tif"
        path.write_bytes(data)
        with pytest.raises(Exception):
            _jax_u8(str(path))
        with pytest.raises(ValueError, match=words):
            mesh_io.load_image(str(path))
    tiled = mt.tiff_file(np.zeros((16, 16, 1), np.uint8), 8, 1,
                         compression=6, tile=(16, 16),
                         raw_strips=[mt.ojpeg_tiff(px[..., :1], 1)[8:]])
    assert _same_as_jax(tmp_path, tiled, "tiled.tif") is not None


def test_ojpeg_undefined_raw_lines_raise(tmp_path):
    """A big-endian YCbCr 2x2 file of several strips whose skipped strips
    take libtiff past the luma blocks libjpeg writes as raw data: Pillow's
    pixels there are libtiff's uninitialised conversion buffer, and the
    port raises saying so."""
    rng = np.random.default_rng(275)
    px = mt.smooth_image(rng, 40, 40, 25.0)
    path = tmp_path / "mm.tif"
    path.write_bytes(mt.ojpeg_tiff(px, 6, subsampling=2, rows_per_strip=16,
                                   order=">"))
    with pytest.raises(ValueError, match=r"unwritten \(undefined in "
                                         r"Pillow\)"):
        mesh_io.load_image(str(path))
    assert [ojpeg.strip_lines(40, 16, 2, swapped)
            for swapped in (False, True)] == [
        [(0, 0, 0, 8), (16, 8, 8, 8), (32, 16, 16, 4)],
        [(0, 0, 0, 8), (16, 8, 16, 8), (32, 24, 32, 4)]]


# ------------------------------------------------------------ ThunderScan

def _thunder_twin(data: bytes, width: int, rows: int):
    """libtiff's ThunderDecode in Python, row by row: the rows' bytes, or
    the error's words."""
    d2, d3 = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    line = (width + 1) // 2
    out = np.zeros((rows, line), np.uint8)
    pos = 0
    for row in range(rows):
        px = []
        last = 0
        while pos < len(data) and len(px) < width:
            c = data[pos]
            pos += 1
            kind = c & 0xC0
            if kind == 0x00:
                n = c & 0x3F
                if len(px) + n <= width:
                    px += [last] * n
                else:
                    px += [None] * n
            elif kind == 0x40:
                for sh in (4, 2, 0):
                    if (c >> sh) & 3 != 2 and len(px) < width:
                        last = (last + d2[(c >> sh) & 3]) & 15
                        px.append(last)
                    elif (c >> sh) & 3 != 2:
                        last = (last + d2[(c >> sh) & 3]) & 15
            elif kind == 0x80:
                for sh in (3, 0):
                    if (c >> sh) & 7 != 4 and len(px) < width:
                        last = (last + d3[(c >> sh) & 7]) & 15
                        px.append(last)
                    elif (c >> sh) & 7 != 4:
                        last = (last + d3[(c >> sh) & 7]) & 15
            else:
                last = c & 15
                if len(px) < width:
                    px.append(last)
        if len(px) != width:
            return "Not enough" if len(px) < width else "Too much"
        nib = np.array(px + [0] * (2 * line - width), np.uint8)
        out[row] = nib[0::2] << 4 | nib[1::2]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_thunder_rows_match_a_python_twin(seed):
    """native.thunder against a Python ThunderDecode on seeded rows of
    every code kind (runs, 2-bit and 3-bit deltas with skip codes, raw)
    and on random bytes, whose rows end short or run over."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 6))
    px = (np.cumsum(rng.integers(-3, 4, (h, w)), 1) % 16).astype(np.uint8)
    coded = b"".join(mt.thunder_row(r, rng) for r in px)
    np.testing.assert_array_equal(native.thunder(coded, w, h),
                                  _thunder_twin(coded, w, h))
    got = native.thunder(coded, w, h)
    nib = np.stack([got >> 4, got & 15], -1).reshape(h, -1)[:, :w]
    np.testing.assert_array_equal(nib, px)
    for _ in range(20):
        junk = rng.integers(0, 256, int(rng.integers(1, 3 * w))).astype(
            np.uint8).tobytes()
        want = _thunder_twin(junk, w, 1)
        if isinstance(want, str):
            with pytest.raises(ValueError, match=want):
                native.thunder(junk, w, 1)
        else:
            np.testing.assert_array_equal(native.thunder(junk, w, 1), want)


@pytest.mark.parametrize("w,h,rps,photo", [
    (1, 3, None, 1), (7, 5, None, 1), (16, 6, 2, 1), (33, 9, 4, 0),
    (40, 7, 3, 3)])
def test_thunderscan_matches_jax(tmp_path, w, h, rps, photo):
    """ThunderScan 4-bit strips of seeded images (each code kind), odd
    widths, several strips, MinIsWhite and a 4-bit palette."""
    rng = np.random.default_rng(w * h + photo)
    px = (np.cumsum(rng.integers(-2, 3, (h, w)), 1) % 16).astype(np.uint8)
    step = rps or h
    strips = [b"".join(mt.thunder_row(r, rng) for r in px[y:y + step])
              for y in range(0, h, step)]
    cmap = None
    if photo == 3:
        cmap = rng.integers(0, 65536, 3 * 16).tolist()
    want = _same_as_jax(tmp_path, mt.tiff_file(
        px[..., None], 4, photo, compression=32809, raw_strips=strips,
        rows_per_strip=rps, colormap=cmap))
    assert want is not None


@pytest.mark.parametrize("codes,want", [
    (bytes((0xC3, 0xCF, 0xC0, 0xC8)), [51, 255, 0, 136]),
    (bytes((0xC3, 3)), [51, 51, 51, 51]),
    (bytes((0xC3, 0, 0x41, 0x00, 0xC8, 0, 0xC1)), None),
    (bytes((0xC5, 0x75)), None), (bytes((0xC5, 0x80 | 1 << 3 | 7, 1)), None),
    (bytes((0xC3, 1)), None), (bytes((0xC3, 5)), None)])
def test_thunderscan_codes_match_jax(tmp_path, codes, want):
    """One 4-pixel row of given codes: raw pixels, a run that ends the
    row, an empty run, 2-bit and 3-bit deltas with skips; a row the codes
    leave short or run over raises, as in Pillow."""
    got = _same_as_jax(tmp_path, mt.tiff_file(
        np.zeros((1, 4, 1), np.uint8), 4, 1, compression=32809,
        raw_strips=[codes]))
    if want is not None:
        assert got[0, :, 0].tolist() == want


def test_thunderscan_refusals(tmp_path):
    """libtiff's Thunder decoder takes 4-bit samples only, and it has no
    tile decoder: both refuse, the port in libtiff's words."""
    path = tmp_path / "t8.tif"
    path.write_bytes(mt.tiff_file(np.zeros((2, 2, 1), np.uint8), 8, 1,
                                  compression=32809, raw_strips=[b"\xc1"]))
    with pytest.raises(Exception):
        _jax_u8(str(path))
    with pytest.raises(ValueError, match=r"Wrong bitspersample value \(8\)"):
        mesh_io.load_image(str(path))
    path.write_bytes(mt.tiff_file(np.zeros((2, 2, 1), np.uint8), 4, 1,
                                  compression=32809, tile=(16, 16),
                                  raw_strips=[b"\xc1"]))
    with pytest.raises(Exception):
        _jax_u8(str(path))
    with pytest.raises(ValueError, match=r"ThunderScan tile decoding is not "
                                         r"implemented"):
        mesh_io.load_image(str(path))


# ------------------------------------------------- JPEG YCbCr in planes

@pytest.mark.parametrize("rps,tables,size", [
    (8, False, (13, 11)), (16, False, (16, 24)), (8, True, (24, 17))])
def test_jpeg_ycbcr_planes_match_jax(tmp_path, rps, tables, size):
    """JPEG (7) YCbCr in separate planes, subsampled 1x1: a one-component
    JPEG a plane and strip (with the tables in JPEGTables or in each
    stream), through libtiff's RGBA path."""
    h, w = size
    rng = np.random.default_rng(rps + h)
    px = mt.smooth_image(rng, h, w, 25.0)
    strips, table_bytes = [], None
    for k in range(3):
        for y in range(0, h, rps):
            jpeg = mt._pillow(PIL.fromarray(px[y:y + rps, :, k]), "JPEG",
                              quality=85)
            if tables:
                table_bytes, jpeg = mt.jpeg_split(jpeg)
            strips.append(jpeg)
    extra = [(530, 3, (1, 1))]
    if tables:
        extra.append((347, 7, tuple(table_bytes)))
    want = _same_as_jax(tmp_path, mt.tiff_file(
        np.zeros((h, w, 3), np.uint8), 8, 6, compression=7, planar=2,
        rows_per_strip=rps, raw_strips=strips, extra_tags=extra))
    assert want is not None


def test_jpeg_ycbcr_planes_subsampled_are_refused_as_in_pillow(tmp_path):
    """YCbCr planes subsampled 2x2: libtiff's RGBA path has no put
    function for them, and Pillow raises."""
    px = np.zeros((16, 16), np.uint8)
    strips = [mt._pillow(PIL.fromarray(px), "JPEG")] * 3
    path = tmp_path / "p.tif"
    path.write_bytes(mt.tiff_file(
        np.zeros((16, 16, 3), np.uint8), 8, 6, compression=7, planar=2,
        raw_strips=strips, extra_tags=[(530, 3, (2, 2))]))
    with pytest.raises(Exception):
        _jax_u8(str(path))
    with pytest.raises(ValueError, match=r"subsampled 2,2 \(planar\)"):
        mesh_io.load_image(str(path))


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("comp,photo,bits,spp,words", [
    (34676, 32844, 16, 1, r"SGILog.*OPEN_INFO has no key.*"
                          r"UnidentifiedImageError"),
    (34677, 32845, 8, 3, r"SGILog24.*OPEN_INFO has no key"),
    (34676, 1, 16, 1, r"SGILog.*takes LogL or LogLuv only"),
    (50001, 2, 8, 3, r"WebP.*WEBP compression support is not configured")])
def test_sgilog_and_webp_tiff_refused_as_in_pillow(tmp_path, comp, photo,
                                                   bits, spp, words):
    """SGILog (Pillow has no mode for LogL or LogLuv, and libtiff's codec
    takes nothing else) and WebP in TIFF (Pillow's libtiff is built
    without it): Pillow raises, and the port raises saying why."""
    dtype = np.uint8 if bits == 8 else np.uint16
    path = tmp_path / "r.tif"
    path.write_bytes(mt.tiff_file(np.zeros((2, 2, spp), dtype), bits, photo,
                                  compression=comp, raw_strips=[bytes(8)]))
    with pytest.raises(Exception):
        with PIL.open(str(path)) as im:
            im.convert("RGB")
    with pytest.raises(ValueError, match=words):
        image_io.load_image(str(path))
