"""JPEG's EXIF and MPF segments as Pillow 12's JpegImagePlugin reads them
(_read_dpi_from_exif at the end of _open, jpeg_factory's _getmp), and
old-style JPEG TIFFs in tiles, in separate planes and of the samplings
libtiff 4.7 would have libjpeg undo, and ThunderScan in tiles or of two
samples, against the JAX package's `load_image` (Pillow's
`convert("RGB")`): cge_tpu_torch/scene/jpeg.py (pillow_open,
exif_dpi, jpeg_factory), scene/ojpeg.py and scene/tiff.py. Every fixture of
tests/torch_textures/jpeg_corners/ (make_textures jpeg_corner_fixtures)
is held to JAX's pixels and its manifest's hash, or to JAX's refusal;
seeded EXIF and MPF directories of every field type and count (the
generators of jax_references/jpeg_segment_probes.py) and seeded tiled,
planar and sampled old-style JPEG files are held to Pillow the same way.
Pixels must be equal exactly; where Pillow refuses a file, the port
raises a ValueError."""

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
from cge_tpu_torch import native
from cge_tpu_torch.scene import blp, image_io, jpeg, mesh_io, ojpeg, tiff
from jax_references import jpeg_segment_probes as probes
from jax_references import make_textures as mt

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_textures", "jpeg_corners")
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


@pytest.mark.parametrize("name", NAMES)
def test_corner_fixtures_match_jax(name):
    """Each fixture: the port's pixels equal JAX's and the manifest's hash
    (what chip_smoke.py's phase 18a checks on the card's machine), or,
    where the manifest has no hash, both refuse the file."""
    entry = next(e for e in MANIFEST["files"] if e["name"] == name)
    path = os.path.join(FOLDER, name)
    if entry["sha256"] is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(Exception):
                _jax_u8(path)
        with pytest.raises(ValueError, match=name):
            mesh_io.load_image(path)
        return
    got = _port_u8(path)
    assert list(got.shape) == entry["shape"]
    np.testing.assert_array_equal(got, _jax_u8(path))
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_corner_manifest_holds_each_case():
    """jpeg_corners/ holds each EXIF and MPF case, the MPO, BLP1 and IPTC
    carriers, each old-style JPEG layout and sampling and the ThunderScan
    refusals, and the chip path's tiled TIFF of the 1024x1024 texels."""
    for stem in ("jpeg_mpf_short_entries", "jpeg_exif_xres_ascii_7",
                 "jpeg_exif_xres_ascii_empty", "jpeg_exif_xres_ascii_72",
                 "jpeg_exif_xres_byte", "jpeg_exif_short_xres_jfif_dpi",
                 "jpeg_mpf_ultra_hdr", "jpeg_mpf_png_entry",
                 "mpo_two_frames", "blp1_jpeg_mpf_short",
                 "iptc_jpeg_mpf_short", "tiff_ojpeg_grey_tiles",
                 "tiff_ojpeg_ycbcr22_tiles", "tiff_ojpeg_ycbcr_planes_",
                 "tiff_ojpeg_ycbcr12_", "tiff_ojpeg_ycbcr41_",
                 "tiff_ojpeg_ycbcr42_", "tiff_ojpeg_ycbcr22_tag21",
                 "tiff_ojpeg_sampled31", "tiff_thunderscan_tiles",
                 "tiff_thunderscan_two_samples"):
        assert any(n.startswith(stem) for n in NAMES), stem
    big = next(e for e in MANIFEST["files"] if e["name"] == mt.CORNERS_OJPEG)
    assert big["shape"] == [1024, 1024, 3]


# ------------------------------------------------------------ the faults

@pytest.mark.parametrize("name", [
    "jpeg_mpf_short_entries_8x8.jpg", "jpeg_exif_xres_ascii_7_8x8.jpg",
    "jpeg_exif_xres_ascii_empty_8x8.jpg"])
def test_segments_jax_refuses_are_refused(name):
    """The three files on which the port parted from JAX's loader: an
    8x8 JPEG, JFIF dropped, with an APP2 MPF index of 2 images and 20
    bytes of MP entries (_getmp's struct.error, which jpeg_factory does
    not catch), or an APP1 Exif directory whose XResolution is the ASCII
    "7" or "" (_read_dpi_from_exif's IndexError). Pillow opens none, and
    the port refuses each with a ValueError."""
    path = os.path.join(FOLDER, name)
    with pytest.raises(PIL.UnidentifiedImageError):
        _jax_u8(path)
    with pytest.raises(ValueError, match="not opened, and no other format"):
        mesh_io.load_image(path)
    with pytest.raises(native.NotOpened):
        jpeg.decode_file(_fixture(name))


def test_exif_control_still_decodes():
    """XResolution "72": float("7") / "2" is a TypeError, which
    _read_dpi_from_exif catches; the file decodes."""
    path = os.path.join(FOLDER, "jpeg_exif_xres_ascii_72_8x8.jpg")
    np.testing.assert_array_equal(_port_u8(path), _jax_u8(path))


def test_mpo_decodes_frame_zero():
    """Pillow's two-frame MPO: jpeg_factory makes it an MPO, whose frame 0
    (the bytes from the file's start) is what JAX's loader returns, and
    its second frame differs."""
    data = _fixture("mpo_two_frames_24x16.mpo")
    assert jpeg.jpeg_factory(data) == "MPO"
    with PIL.open(io.BytesIO(data)) as im:
        assert im.format == "MPO" and im.n_frames == 2
        first = np.asarray(im.convert("RGB"))
        im.seek(1)
        second = np.asarray(im.convert("RGB"))
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(image_io.decode_image(data), first)


@pytest.mark.parametrize("name,kind", [
    ("jpeg_mpf_ultra_hdr_8x8.jpg", "JPEG"),
    ("jpeg_mpf_png_entry_8x8.jpg", "JPEG"),
    ("jpeg_mpf_count_rational_8x8.jpg", "JPEG"),
    ("jpeg_mpf_entries_ascii_8x8.jpg", "JPEG"),
    ("jpeg_mpf_no_entries_8x8.jpg", "JPEG"),
    ("jpeg_mpf_bad_header_8x8.jpg", "JPEG"),
    ("jpeg_exif_xres_ascii_72_8x8.jpg", "JPEG")])
def test_jpeg_factory_keeps_a_jpeg(name, kind):
    """What jpeg_factory catches keeps the file a JPEG, as Image.open's
    format says: an Ultra HDR APP1 beside two images, an entry of another
    image data format (SyntaxError), a NumberOfImages that is no int or
    MP entries that are no bytes (TypeError), no MPEntry tag or a header
    that is no TIFF one (SyntaxError)."""
    data = _fixture(name)
    assert jpeg.jpeg_factory(data) == kind
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with PIL.open(io.BytesIO(data)) as im:
            assert im.format == kind


def test_blp1_reads_its_jpeg_without_jpeg_factory():
    """BLP1's JPEG is a JpegImageFile that Pillow builds itself, so the
    short MPF index jpeg_factory would fail on does not matter there, but
    the EXIF that _open fails on does (at load: a refusal)."""
    data = _fixture("blp1_jpeg_mpf_short_8x8.blp")
    np.testing.assert_array_equal(
        blp.decode_blp(data),
        _jax_u8(os.path.join(FOLDER, "blp1_jpeg_mpf_short_8x8.blp")))
    with pytest.raises(ValueError, match="its JPEG: JPEG EXIF"):
        blp.decode_blp(_fixture("blp1_jpeg_exif_short_xres.blp"))


def test_iptc_nested_jpeg_goes_through_jpeg_factory():
    """IPTC opens its nested JPEG with Image.open: the short MPF index
    leaves it unopened, and the IPTC file is refused."""
    path = os.path.join(FOLDER, "iptc_jpeg_mpf_short.iim")
    with pytest.raises(Exception):
        _jax_u8(path)
    with pytest.raises(ValueError, match="its image data"):
        mesh_io.load_image(path)


# XResolution values of each kind, and what _read_dpi_from_exif does
@pytest.mark.parametrize("typ,count,value,escapes", [
    (2, 1, b"\0", True), (2, 2, b"7\0", True), (2, 1, b"7", True),
    (2, 2, b"x\0", False), (2, 2, b" \0", False), (2, 3, b"72\0", False),
    (2, 3, b"7\0\0", False), (1, 1, b"\x07", True), (7, 1, b"\0", True),
    (1, 2, b"\x07\x00", False), (7, 3, b"abc", False),
    (3, 1, b"\x48\0", False), (5, 1, struct.pack("<II", 1, 0), False),
    (12, 1, struct.pack("<d", float("nan")), False),
    (17, 1, bytes(8), False), (7, 0, b"", False)])
def test_exif_xresolution_kinds(tmp_path, typ, count, value, escapes):
    """Each kind of XResolution beside a ResolutionUnit: the port opens
    the file where Pillow does, and refuses it where the IndexError
    escapes (BYTE or UNDEFINED of one byte, ASCII empty or one digit)."""
    data = mt.jpeg_with_segments(probes.pillow_base(),
                                 [mt.exif_segment([
                                     (0x0128, 3, 1, struct.pack("<H", 3)),
                                     (0x011A, typ, count, value)])])
    got = _same_as_jax(tmp_path, data, "x.jpg")
    assert (got is None) == escapes


@pytest.mark.parametrize("kind", ["exif", "mpf"])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_segments_match_pillow(kind, seed):
    """Seeded EXIF and MPF segments (jpeg_segment_probes' generators:
    every field type and count, cut directories, JFIF units, byte orders,
    Ultra HDR markers): the port's pixels equal Pillow's, or both
    refuse."""
    rng = np.random.default_rng(1000 * seed + len(kind))
    case = probes.exif_case if kind == "exif" else probes.mpf_case
    base = probes.pillow_base()
    for _ in range(60):
        data = case(rng, base)
        want, got = probes.pillow(data), probes.port(data)
        if isinstance(want, str):
            assert isinstance(got, str), data.hex()
        else:
            assert not isinstance(got, str), (got, data.hex())
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ old-style JPEG

OJPEG_LAYOUTS = {
    "grey_tiles_stream": (1, dict(tile=(16, 16))),
    "grey_tiles_tables": (1, dict(form="tables", tile=(16, 16))),
    "grey_tiles_jif_mm": (1, dict(form="jif", order=">", tile=(16, 32))),
    "ycbcr22_tiles_stream": (6, dict(subsampling=2, tile=(16, 16))),
    "ycbcr22_tiles_tables": (6, dict(subsampling=2, form="tables",
                                     tile=(32, 16))),
    "ycbcr21_tiles_jif_mm": (6, dict(subsampling=1, form="jif", order=">",
                                     tile=(16, 16))),
    "ycbcr11_tiles_tables": (6, dict(form="tables", tile=(16, 16))),
    "planes_stream": (6, dict(planar=2, sampling=((1, 1),) * 3)),
    "planes_jif_strips": (6, dict(planar=2, sampling=((1, 1),) * 3,
                                  form="jif", rows_per_strip=8)),
    "planes_stream_strips_mm": (6, dict(planar=2, sampling=((1, 1),) * 3,
                                        rows_per_strip=8, order=">")),
    "planes_tiles": (6, dict(planar=2, sampling=((1, 1),) * 3,
                             tile=(16, 16))),
    "planes_sampled22": (6, dict(planar=2, sampling=((2, 2), (1, 1),
                                                     (1, 1)))),
}


@pytest.mark.parametrize("size", [(32, 32), (20, 24), (16, 40), (40, 16)])
@pytest.mark.parametrize("case", sorted(OJPEG_LAYOUTS))
def test_ojpeg_tiles_and_planes_match_jax(tmp_path, case, size):
    """Old-style JPEG in tiles (the stream's frame one tile wide, the
    tiles one under another; tables in tags rebuild a frame of one tile
    column, so the later columns read past it: grey keeps Pillow's tile
    buffer, YCbCr the last iMCU row) and in separate planes (a
    one-component stream a plane from its own SOS, each strile restarted
    as TIFFRGBAImage reads the planes in turn), grey and YCbCr, II and
    MM, cut tiles; planes subsampled are refused as in Pillow."""
    photo, kw = OJPEG_LAYOUTS[case]
    h, w = size
    rng = np.random.default_rng(sum(map(ord, case)) + h * w)
    px = mt.smooth_image(rng, h, w, 25.0)
    want = _same_as_jax(tmp_path, mt.ojpeg_tiff(
        px[..., :1] if photo == 1 else px, photo, quality=80, **kw), "t.tif")
    assert (want is None) == (case == "planes_sampled22")


SAMPLINGS = [((1, 2), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
             ((2, 1), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
             ((4, 2), (1, 1), (1, 1)), ((3, 1), (1, 1), (1, 1)),
             ((1, 1), (2, 2), (2, 2)), ((2, 2), (1, 1), (2, 1)),
             ((2, 1), (1, 2), (1, 1))]


@pytest.mark.parametrize("tag", [None, (2, 2), (1, 1), ()],
                         ids=["tag_as_frame", "tag22", "tag11", "no_tag"])
@pytest.mark.parametrize("sampling", SAMPLINGS,
                         ids=["_".join(f"{a}{b}" for a, b in s)
                              for s in SAMPLINGS])
def test_ojpeg_samplings_match_jax(tmp_path, sampling, tag):
    """Frames of each sampling under a YCbCrSubsampling tag that matches,
    differs or is missing: libtiff takes the frame's first factors where
    they are 1, 2 or 4 and the others 1x1 (whatever the tag says); else
    OJPEGSubsamplingCorrect would have libjpeg desubsample, and
    jpeg_start_decompress's factors contradict the 1x1 it then expects,
    so Pillow refuses: the port refuses too, in libtiff's words."""
    rng = np.random.default_rng(sum(a * 3 + b for a, b in sampling))
    px = mt.smooth_image(rng, 32, 40, 25.0)
    forced = sampling[0][0] == 3 or any(s != (1, 1) for s in sampling[1:])
    for extra in ({}, dict(tile=(16, 32))):
        data = mt.ojpeg_tiff(px, 6, quality=85, sampling=sampling,
                             subsampling_tag=tag, **extra)
        want = _same_as_jax(tmp_path, data, "s.tif")
        assert (want is None) == forced
        if forced:
            with pytest.raises(ValueError, match="expected 1 and 1"):
                tiff.decode_tiff(data)


# damaged layouts: a corrupt SOS of plane 1 leaves libtiff's stream where
# its search ended and plane 0's unrestarted session reads on from there,
# which the port follows; where that stop lies before the last 2,048-byte
# window of its strile and a third strile reads on, it refuses, naming the
# case (a standing record: libjpeg's read-ahead points into the buffer the
# next search refills)
DAMAGED = {
    "tiles_grey": (1, dict(form="jif", tile=(16, 16))),
    "tiles_ycbcr22": (6, dict(subsampling=2, tile=(16, 16))),
    "tiles_ycbcr11_mm": (6, dict(form="jif", order=">", tile=(16, 16))),
    "planes_strips": (6, dict(planar=2, sampling=((1, 1),) * 3, form="jif",
                              rows_per_strip=8)),
    "planes": (6, dict(planar=2, sampling=((1, 1),) * 3)),
}
KNOWN_GAP = "not followed"


@pytest.mark.parametrize("case", sorted(DAMAGED))
def test_ojpeg_damaged_tiles_and_planes_match_jax(tmp_path, case):
    """Tiled and planar files whose striles are zeroed from a point on or
    have bytes changed: the port gives Pillow's pixels or raises where
    Pillow raises (a plane whose SOS libtiff cannot find reads as zeros,
    and where that is plane 1 plane 0's later striles read on from where
    the search stopped; the one standing refusal is named above)."""
    photo, kw = DAMAGED[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    px = mt.smooth_image(rng, 32, 32, 25.0)
    data = mt.ojpeg_tiff(px[..., :1] if photo == 1 else px, photo, **kw)
    tags = tiff._ifd(data)[2]
    ifd = struct.unpack_from("<I" if data[:2] == b"II" else ">I", data, 4)[0]
    start = min(tiff._list(tags.get(273, tags.get(324))))
    files = [data[:cut] + bytes(ifd - cut) + data[ifd:] for cut in sorted(
        set(rng.integers(start, ifd, 8).tolist()))]
    for k in range(16):
        b = bytearray(data)
        for pos in rng.integers(start, ifd, 1 + k % 2):
            b[pos] = int(rng.integers(0, 256))
        files.append(bytes(b))
    for i, damaged in enumerate(files):
        try:
            _same_as_jax(tmp_path, damaged, f"d{i}.tif")
        except AssertionError:
            with pytest.raises(ValueError, match=KNOWN_GAP):
                tiff.decode_tiff(damaged)


def test_ojpeg_planes_without_a_plane_sos(tmp_path):
    """A planar file whose plane 2 has no SOS that libtiff can find reads
    it as zeros (its reads fail, its buffer stays zeroed), as Pillow
    does; plane 0's decoding stops at its scan, where libtiff's libjpeg
    session stops, not at the next plane's markers."""
    rng = np.random.default_rng(290)
    px = mt.smooth_image(rng, 24, 24, 25.0)
    data = mt.ojpeg_tiff(px, 6, planar=2, sampling=((1, 1),) * 3,
                         form="jif", rows_per_strip=8)
    tags = tiff._ifd(data)[2]
    plane2 = tiff._list(tags[273])[6]
    ifd = struct.unpack_from("<I", data, 4)[0]
    cut = data[:plane2] + bytes(ifd - plane2) + data[ifd:]
    jpegs, _, _, _ = ojpeg.streams(cut, tags, 24, 24, 3, True, "t")
    assert [j is None for j in jpegs] == [False, False, True]
    want = _same_as_jax(tmp_path, cut, "p.tif")
    assert want is not None
    # tables in tags and a plane's SOS that names another component than
    # the frame rebuilt from them: libjpeg refuses the plane's header, and
    # with one strip a plane it reads as zeros
    tables = mt.ojpeg_tiff(px, 6, planar=2, sampling=((1, 1),) * 3,
                           form="tables", subsampling_tag=(1, 1))
    assert _same_as_jax(tmp_path, tables, "t.tif") is not None


def test_thunderscan_tiles_and_samples_refused_as_in_jax():
    """libtiff has no ThunderScan tile decoder, and Pillow has no mode for
    4-bit samples of more than one a pixel: both refuse, the port naming
    why."""
    for name, words in (("tiff_thunderscan_tiles_32x32.tif",
                         r"ThunderScan tile decoding is not implemented"),
                        ("tiff_thunderscan_two_samples_32x32.tif",
                         r"not a mode Pillow reads")):
        with pytest.raises(ValueError, match=words):
            tiff.decode_tiff(_fixture(name))


@pytest.mark.parametrize("tag", [270, 305, 65000])
@pytest.mark.parametrize("compression", [1, 5])
def test_tiff_tag_value_cut_short_ends_the_directory(tmp_path, tag,
                                                     compression):
    """The IFD walk the EXIF and MPF readers share with the TIFF reader
    (tiff.ifd_entries): a tag whose out-of-line value lies past the file's
    end ends Pillow's directory there (ImageFileDirectory_v2.load stops at
    its OSError), so the tags after it are lost: before the strips' tags
    the file is refused, after them it decodes. The port skipped such a
    tag and read on."""
    px = mt.smooth_image(np.random.default_rng(tag), 6, 5, 25.0)
    data = bytearray(mt.tiff_file(px, 8, 2, compression=compression,
                                  extra_tags=[(tag, 4, (1, 2, 3, 4, 5))]))
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == tag:
            struct.pack_into("<I", data, ifd + 2 + 12 * i + 8, 1 << 20)
    want = _same_as_jax(tmp_path, bytes(data), "cut.tif")
    assert (want is None) == (tag < 273)
