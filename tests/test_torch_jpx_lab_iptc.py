"""The last texture tails the port follows Pillow 12 on, against the JAX
package's `load_image` (Pillow's `convert("RGB")`): JP2 colr boxes of
CIELab of any size and JPX files (cge_tpu_torch/scene/jpeg2000.py, as
OpenJPEG 2.5.4 reads them), IM's bare "LAB" type (scene/im.py, LittleCMS's
Lab -> sRGB of each L value), IPTC band images of every nested format and
mode (scene/iptc.py through image_io.open_image, each format's opener and
modes.merge_band), and planar old-style JPEG TIFFs whose plane 1 SOS
libtiff cannot take (scene/ojpeg.py). Every fixture of
tests/torch_textures/jpx_lab_iptc/ (make_textures tails_fixtures) is held
to JAX's pixels and its manifest's hash, or to JAX's refusal, or, where
JAX's process dies (Pillow's merge of a band of mode I or F), to a
Pillow worker process that dies; the generators of
jax_references/tail_probes.py are held to Pillow the same way. Pixels must
be equal exactly; where Pillow refuses a file, the port raises a
ValueError."""

import hashlib
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch.scene import image_io, lcms, mesh_io, modes, ojpeg, tiff
from jax_references import make_textures as mt
from jax_references import tail_probes as probes

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_textures")
FOLDER = os.path.join(ROOT, "jpx_lab_iptc")
with open(os.path.join(FOLDER, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NAMES = [e["name"] for e in MANIFEST["files"]]


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="t.bin"):
    """The port's pixels equal JAX's, or both raise (the port a
    ValueError naming the file). JAX's pixels, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = _jax_u8(path)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match=name):
            mesh_io.load_image(path)
        return None
    np.testing.assert_array_equal(_port_u8(path), want)
    return want


def _fixture(name):
    with open(os.path.join(FOLDER, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def _close_worker():
    yield
    probes._WORKER.close()


@pytest.mark.parametrize("name", NAMES)
def test_tails_fixtures_match_jax(name):
    """Each fixture: the port's pixels equal JAX's and the manifest's hash
    (what chip_smoke.py's phase 18a checks on the card's machine); where
    the manifest has no hash both refuse the file, and where JAX's process
    dies on it, so does a Pillow worker's, and the port refuses it."""
    entry = next(e for e in MANIFEST["files"] if e["name"] == name)
    path = os.path.join(FOLDER, name)
    if entry["sha256"] is None:
        with pytest.raises(ValueError, match=name):
            mesh_io.load_image(path)
        if entry["jax_error"] == "died":
            assert probes.pillow_rgb(_fixture(name))[0] == "died"
        else:
            with pytest.raises(Exception), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _jax_u8(path)
        return
    got = _port_u8(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(got, _jax_u8(path))


@pytest.mark.parametrize("size", [7, 8, 11, 19, 34, 35, 36, 39, 40])
@pytest.mark.parametrize("then", [None, 18])
def test_cielab_colr_of_any_size_decodes_as_jax(tmp_path, size, then):
    """A CIELab colr box (method 1, EnumCS 14) of any size from 7 bytes:
    OpenJPEG warns and takes the default parameters (it reads them only at
    35 bytes) and the colour space stays unspecified; the box is still the
    first colr, so an sYCC colr after it is ignored. The port refused every
    size but 7 and 35."""
    rng = np.random.default_rng(size)
    cs = mt._pillow(PIL.fromarray(mt.smooth_image(rng, 6, 9, 25.0)),
                    "JPEG2000", no_jp2=True)
    colr = (mt._lab_colr(size),) + (() if then is None else ((1, then),))
    want = _same_as_jax(tmp_path, mt.jp2_file(cs, colr=colr), "lab.jp2")
    assert want is not None


@pytest.mark.parametrize("size", range(0, 7))
def test_cielab_colr_under_seven_bytes_is_refused_as_in_jax(tmp_path, size):
    """Method 1 in a colr of fewer than 7 bytes: OpenJPEG's "Bad COLR
    header box (bad size)" ends the decoding, in Pillow and the port."""
    cs = mt._pillow(PIL.fromarray(mt.smooth_image(
        np.random.default_rng(0), 6, 9, 25.0)), "JPEG2000", no_jp2=True)
    data = mt.jp2_file(cs, colr=(mt._lab_colr(size),))
    assert _same_as_jax(tmp_path, data, "short.jp2") is None


@pytest.mark.parametrize("case", range(8))
def test_jpx_boxes_match_jax(case):
    """Seeded JPX files of jax_references/tail_probes.jpx_cases (the jpx
    brand, rreq, jpch / jplh / cgrp, ftbl, dtbl, asoc, a second
    codestream, colr methods 0-5, EnumCS 19-25, CIELab on one to four
    components, files without jp2h or jp2c) against a Pillow worker: a
    slice of the cases each."""
    cases = list(probes.jpx_cases(np.random.default_rng(30)))
    for name, data in cases[case::8]:
        same, want, got = probes.agree(data)
        assert same, (name, probes._show(want), probes._show(got))


@pytest.mark.parametrize("lut", [None, "grey", "colour"])
def test_im_lab_is_lcms_of_each_l_value(lut):
    """IM "Image type: LAB" read with the L layout: Pillow's band 0
    unpacker makes the bytes L and leaves a and b 0, and convert("RGB")
    is LittleCMS's Lab -> sRGB of (L, 0, 0) for each of the 256 values; a
    Lut (skipped) changes nothing. The port refused the type as not
    ported."""
    ramp = np.arange(256, dtype=np.uint8)
    table = {None: None, "grey": np.tile(ramp, 3).tobytes(),
             "colour": np.random.default_rng(1).integers(
                 0, 256, 768).astype(np.uint8).tobytes()}[lut]
    data = mt.im_file(b"LAB", 16, 16, ramp.tobytes(), lut=table)
    lab = np.zeros((16, 16, 3), np.uint8)
    lab[..., 0] = ramp.reshape(16, 16)[::-1]        # rows from the bottom
    np.testing.assert_array_equal(image_io.decode_image(data),
                                  lcms.lab_to_rgb(lab))
    same, want, got = probes.agree(data)
    assert same, (probes._show(want), probes._show(got))


def test_im_lab_after_each_type_line_matches_jax():
    """A bare LAB type after each type of Pillow's OPEN table, which
    leaves its layout: only the L layout has an unpacker into LAB, the
    others (and the bit decoder's F;N, which takes F only) are refused."""
    for name, data in probes.im_cases():
        same, want, got = probes.agree(data)
        assert same, (name, probes._show(want), probes._show(got))


@pytest.mark.parametrize("fmt", sorted(probes.NESTED))
def test_iptc_bands_of_each_nested_format_match_pillow(fmt):
    """RGB and CMYK IPTC streams (and L ones) whose band image is a file
    Pillow writes as fmt in each of its modes, in each band: the first
    band may be any image of one band (1, L, P as its indices, I;16 as its
    row's bytes), the others must be L, several bands are refused, and a
    first band of I or F kills Pillow's process (the worker's here) where
    the port refuses it."""
    rng = np.random.default_rng(sum(map(ord, fmt)))
    cases = [(n, d) for n, d in probes.iptc_cases(rng)
             if n.split()[0] == fmt]
    assert cases
    for name, data in cases:
        same, want, got = probes.agree(data)
        assert same, (name, probes._show(want), probes._show(got))
        if want[0] == "died":
            assert "band 0" in got[2], got


def test_merge_band_reads_each_rows_stored_bytes():
    """ImagingMerge reads a byte a pixel from the rows of the first band:
    pixel x of an I;16 row is byte x of its little-endian storage, of
    I;16B of its big-endian one; 1, L and P are their pixels; other modes
    have no band."""
    px = np.array([[1, 25702, 0x1234, 0xABCD]], np.uint16)
    np.testing.assert_array_equal(modes.merge_band("I;16", px),
                                  [[1, 0, 102, 100]])
    np.testing.assert_array_equal(modes.merge_band("I;16B", px),
                                  [[0, 1, 100, 102]])
    idx = np.array([[3, 0, 255]], np.uint8)
    for mode in ("1", "L", "P"):
        assert modes.merge_band(mode, idx) is idx
    for mode in ("I", "F", "RGB", "LA"):
        assert modes.merge_band(mode, np.zeros((1, 3, 3), np.uint8)) is None


def _small_fixtures():
    """Every fixture under 200 KB but those JAX's process dies on."""
    dies = {e["name"] for e in MANIFEST["files"]
            if e.get("jax_error") == "died"}
    out = []
    for folder, _, names in sorted(os.walk(ROOT)):
        for name in sorted(names):
            path = os.path.join(folder, name)
            if (name != "manifest.json" and name not in dies
                    and os.path.getsize(path) < 200_000):
                out.append(os.path.relpath(path, ROOT))
    return out


@pytest.mark.parametrize("rel", _small_fixtures())
def test_open_image_gives_pillows_mode_and_band(rel):
    """image_io.open_image, the dispatch IPTC opens its nested image
    through, on every texture fixture: Pillow's mode (one of the
    alternatives a format that opens only in modes of several bands
    names), and for 1, L, P and the I;16 modes Pillow's pixels (its
    indices for P, 0 or 255 for 1); refused where Pillow refuses it. An L
    IPTC stream is L to Pillow whatever its nested image's mode, which the
    port reports. Pillow opens the bytes from memory here, and so does the
    port (in_memory)."""
    with open(os.path.join(ROOT, rel), "rb") as f:
        data = f.read()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = PIL.open(io.BytesIO(data))
            im.load()
            want = im.mode, (np.asarray(im) if im.mode in (
                "L", "P", "I;16", "I;16L", "I;16B") else np.asarray(
                    im, np.uint8) * np.uint8(255) if im.mode == "1" else None)
    except Exception:
        with pytest.raises(ValueError):
            image_io.open_image(data, in_memory=True)
        return
    try:
        mode, px, _ = image_io.open_image(data, in_memory=True)
    except ValueError:
        # what Pillow's open and load pass but convert("RGB") or the
        # port's own checks refuse (held to JAX by the other tests)
        with pytest.raises(Exception), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im.convert("RGB")
        return
    if im.format == "IPTC" and want[0] == "L":
        return
    assert want[0] in mode.split(" or "), (mode, want[0])
    if want[1] is not None:
        np.testing.assert_array_equal(px, want[1])


def test_in_memory_mcidas_refuses_lines_shorter_than_their_stride():
    """Pillow maps an McIdas file and reads overlapping lines from the
    map; a nested image in memory goes to its raw decoder, which refuses a
    stride shorter than a line ("codec configuration error"), and an L
    IPTC stream of such a file so fails in Pillow and the port."""
    grey = mt.smooth_image(np.random.default_rng(5), 4, 6, 25.0)[..., 1]
    area = mt.mcidas_file(grey, prefix=2, words={14: 0})
    assert image_io.open_image(area)[0] == "L"
    with pytest.raises(ValueError, match="shorter than"):
        image_io.open_image(area, in_memory=True)
    same, want, got = probes.agree(mt.iptc_file(area, 6, 4, compression=5))
    assert same and want[0] == "error", (probes._show(want), got)


@pytest.mark.parametrize("case", range(10))
def test_planar_ojpeg_plane1_sos_matches_pillow(case):
    """Planar old-style JPEG TIFFs of one or several striles a plane whose
    plane 1 (or 2) SOS is corrupt, missing or cut (the generator of
    jax_references/tail_probes.ojpeg_cases): where plane 1's search fails
    plane 0's libjpeg session, which libtiff leaves live, reads its later
    striles from where the search stopped (each the first restart interval
    from there), or at the stream's end fails the next strile and then the
    skip to the one after, which ends TIFFRGBAImageGet where it starts a
    call; a refused header stops every later session. A slice of 100 of
    the cases each, against a Pillow worker; the one case the port does not
    follow (test below) is named."""
    cases = list(probes.ojpeg_cases(np.random.default_rng(case), 100))
    for name, data in cases:
        same, want, got = probes.agree(data)
        if not same and got[0] == "error" and "not followed" in got[2]:
            continue
        assert same, (name, probes._show(want), probes._show(got))


def test_planar_ojpeg_plane1_sos_past_its_window_is_a_standing_refusal(
        tmp_path):
    """A corrupt plane 1 SOS before the last 2,048-byte window of its
    strile (libtiff's OJPEG_BUFFER), with three striles a plane: plane 0's
    second strile reads on from the search's stop, and libjpeg's read-ahead
    past that window then points into the buffer each later search
    refills. Pillow returns deterministic pixels there, which the port
    does not follow: it refuses, naming the case (ROADMAP, standing
    records)."""
    rng = np.random.default_rng(201)
    px = rng.integers(0, 256, (48, 640, 3)).astype(np.uint8)
    b = bytearray(mt.ojpeg_tiff(px, 6, planar=2, sampling=((1, 1),) * 3,
                                form="jif", rows_per_strip=16, quality=95))
    at = [i for i in range(len(b) - 1) if b[i:i + 2] == b"\xff\xda"]
    b[at[1] + 4] = 3
    tags = tiff._ifd(bytes(b))[2]
    assert max(tiff._list(tags[279])) > 2048
    path = str(tmp_path / "window.tif")
    with open(path, "wb") as f:
        f.write(bytes(b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _jax_u8(path).shape == (48, 640, 3)
    with pytest.raises(ValueError, match="not followed"):
        mesh_io.load_image(path)


def test_planar_ojpeg_plane1_resumed_strile_is_its_first_interval():
    """Where plane 1's SOS is corrupt, every later strile of plane 0 is the
    first restart interval read from where libtiff's search stopped: the
    same lines each time (the search runs again before each)."""
    data = _fixture("tiff_ojpeg_planes_plane1_sos_length_strips_48x40.tif")
    y, cb, cr, _ = ojpeg.decode(data, tiff._ifd(data)[2], 48, 40, 3,
                                True, "t")
    assert not cb.any() and not cr.any()
    for k in range(2, 5):
        np.testing.assert_array_equal(y[8 * k:8 * k + 8], y[8:16])
    assert (y[:8] != y[8:16]).any()


def test_tails_chip_file_is_the_green_crop_in_band_1():
    """chip_smoke.py phase 18c's IPTC row: band 1 of RGB is the PNG of the
    texels' top-left 256x256 crop's green, the other bands black."""
    got = image_io.decode_image(_fixture(mt.TAILS_CHIP))
    assert got.shape == (mt.TAILS_CROP, mt.TAILS_CROP, 3)
    with open(os.path.join(ROOT, mt.BIG), "rb") as f:
        texels = image_io.decode_image(f.read())
    np.testing.assert_array_equal(
        got[..., 1], texels[:mt.TAILS_CROP, :mt.TAILS_CROP, 1])
    assert not got[..., 0].any() and not got[..., 2].any()
    assert struct.unpack(">H", _fixture(mt.TAILS_CHIP)[3:5])[0] == 2
