"""The port's JPEG 2000 reader (cge_tpu_torch/scene/jpeg2000.py, the
codestream in native/cge_j2k.cpp) against Pillow 12 over OpenJPEG 2.5.4,
which the JAX package's loader uses: the fixtures of both manifests, seeded
random files Pillow saves (numpy default_rng), codestreams of OpenJPEG's own
encoder for what Pillow's save cannot set (jax_references/j2k_encoder.py:
code-block styles, ROI, POC, subsampled components, precisions 1 to 16,
offsets, tile-parts, SOP / EPH), PPT / PPM and JP2 boxes rewritten by hand
(jax_references/make_textures.py), files cut at several offsets and with
flipped bytes, every refusal's message, and the native inverse 5/3
transform and RCT against a numpy twin. Pixels must be equal exactly (u8 /
255 as float32, as the JAX loader gives them); where Pillow refuses a file,
the port raises a ValueError that names JPEG 2000."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, jpeg2000, mesh_io
from jax_references import make_textures as mt
from jax_references.j2k_encoder import STYLE, j2k_encode

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_textures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
with open(os.path.join(FIXTURES, "j2k_chip", "manifest.json")) as _f:
    CHIP_MANIFEST = json.load(_f)
J2K_FIXTURES = [f["name"] for f in MANIFEST["files"]
                if f["kind"] in ("j2k", "jp2")]
# what the port refuses though Pillow decodes it (ROADMAP queue 3)
KNOWN_GAPS = r"HTJ2K|Part 2"


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="texture.bin"):
    """The port's pixels equal JAX's; where JAX's loader (Pillow) raises,
    the port raises a ValueError that names the file and JPEG 2000 (or the
    format of the file's first bytes). JAX's pixels, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
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


def _pillow(img, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "JPEG2000", **kw)
    return b.getvalue()


def test_manifest_holds_the_jpeg2000_cases():
    """The fixtures cover Pillow's saves, each code-block style, ROI, POC,
    subsampling, precisions, offsets, tile-parts, PPT / PPM and the JP2
    boxes, and the chip path's three files are in their own manifest."""
    names = set(J2K_FIXTURES)
    for stem in ("j2k_pillow_l_", "j2k_pillow_rgba_", "j2k_pillow_la_",
                 "j2k_pillow_i16_", "j2k_pillow_l_signed_",
                 "j2k_pillow_97_layers_", "j2k_pillow_lrcp_",
                 "j2k_pillow_rlcp_", "j2k_pillow_rpcl_", "j2k_pillow_pcrl_",
                 "j2k_pillow_cprl_", "j2k_pillow_tiles_", "j2k_pillow_plt_",
                 "j2k_roi_", "j2k_poc_", "j2k_subsampled_420_",
                 "jp2_subsampled_422_", "j2k_prec1_", "j2k_prec16_",
                 "j2k_prec13_signed_", "j2k_offsets_", "j2k_tile_parts_R",
                 "j2k_tile_parts_C", "j2k_sop_eph_", "j2k_ppt_", "j2k_ppm_",
                 "jp2_pclr_repeated_", "jp2_pclr_rgba_",
                 "jp2_cdef_alpha_first_", "jp2_colr12_", "jp2_colr16_res_",
                 "jp2_colr17_", "jp2_colr18_"):
        assert any(n.startswith(stem) for n in names), stem
    for style in STYLE:
        assert f"j2k_style_{style}_9x11.j2k" in names
    assert {f["name"] for f in CHIP_MANIFEST["files"]} == {
        mt.J2K_LOSSLESS, mt.JP2_LOSSY, mt.ICNS_JP2}
    assert CHIP_MANIFEST["openjpeg"] == "2.5.4"


@pytest.mark.parametrize("name", [f["name"] for f in CHIP_MANIFEST["files"]])
def test_chip_files_match_jax(name):
    """The chip path's lossless 512x512 J2K crop, lossy 1024x1024 JP2 and
    its ICNS: the port's pixels equal JAX's and the manifest's hash."""
    import hashlib

    entry = next(f for f in CHIP_MANIFEST["files"] if f["name"] == name)
    path = os.path.join(FIXTURES, "j2k_chip", name)
    port = _port_u8(path)
    assert list(port.shape) == entry["shape"]
    np.testing.assert_array_equal(port, _jax_u8(path))
    assert hashlib.sha256(port.tobytes()).hexdigest() == entry["sha256"]


def _random_save(seed: int) -> bytes:
    """A seeded image saved by Pillow with seeded options: the mode, the
    size, 5/3 or 9/7, the progression, layers, tiles, code-block and
    precinct sizes, resolutions, MCT, signed, J2K or JP2, PLT. The options
    keep clear of OpenJPEG's encoder asserting (a 9/7 transform of one
    sample) and of Pillow's image offsets, which its encoder mishandles;
    where Pillow's save refuses them, the same generator draws again."""
    rng = np.random.default_rng(seed)
    while True:
        mode = str(rng.choice(["L", "RGB", "RGBA", "LA", "I;16", "P"]))
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        kw = {}
        if rng.random() < 0.5:
            kw["irreversible"] = True
        if rng.random() < 0.5:
            kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL",
                                                "PCRL", "CPRL"]))
        if rng.random() < 0.4:
            kw["quality_layers"] = sorted(
                (float(v) for v in rng.integers(2, 60, int(rng.integers(
                    1, 4)))), reverse=True)
        if rng.random() < 0.4:
            kw["tile_size"] = tuple(int(v) for v in rng.integers(8, 40, 2))
        if rng.random() < 0.4:
            kw["codeblock_size"] = tuple(int(2 ** v) for v in rng.integers(
                2, 7, 2))
        if rng.random() < 0.4:
            kw["precinct_size"] = tuple(int(2 ** v) for v in rng.integers(
                2, 8, 2))
        for key, p in (("mct", 0.3), ("signed", 0.2), ("no_jp2", 0.5),
                       ("plt", 0.2)):
            if rng.random() < p:
                kw[key] = True
        tw, th = kw.get("tile_size", (w, h))
        sides = [h, w, min(tw, w), min(th, h)]
        nres = min(int(rng.integers(1, 7)),
                   int(np.log2(min(sides))) + 1)
        kw["num_resolutions"] = nres
        lim = 2 ** (nres - 1) + 1
        if kw.get("irreversible") and min(
                sides + [w % tw or lim, h % th or lim]) < lim:
            continue
        if mode == "I;16":
            img = PIL.fromarray(rng.integers(
                0, 1 << int(rng.integers(9, 17)), (h, w)).astype(np.uint16))
        else:
            rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            if rng.random() < 0.5:
                rgb = rgb // 48 * 48
            img = PIL.fromarray(rgb)
            img = img.convert("RGB").convert("P") if mode == "P" else \
                img.convert(mode)
        try:
            return _pillow(img, **kw)
        except OSError:
            continue


@pytest.mark.parametrize("seed", range(40))
def test_random_pillow_saves_match_jax(tmp_path, seed):
    """Files Pillow saves with seeded random modes, sizes and options decode
    to JAX's pixels."""
    _same_as_jax(tmp_path, _random_save(seed))


def _planes(rng, sampling, h, w, prec=8, signed=False, off=(0, 0)):
    """Random components of an image h x w samples of the first component
    at its sampling, at offset off on the reference grid."""
    dx0, dy0 = sampling[0]
    x1, y1 = off[0] + w * dx0, off[1] + h * dy0
    lo = -(1 << (prec - 1)) if signed else 0
    out = []
    for dx, dy in sampling:
        cx0, cy0 = -(-off[0] // dx), -(-off[1] // dy)
        out.append(rng.integers(lo, lo + (1 << prec),
                                (-(-y1 // dy) - cy0, -(-x1 // dx) - cx0)))
    return out


_ENCODER_CASES = {
    **{f"style_{s}": dict(styles=[s], codeblock=(4, 4), layers=[2.5, 1.2])
       for s in STYLE},
    **{f"style_{s}_lossless": dict(styles=[s], codeblock=(8, 8))
       for s in ("bypass", "reset", "vsc", "pterm", "segsym")},
    "styles_all_97": dict(styles=list(STYLE), irreversible=True,
                          layers=[3, 1.5], codeblock=(8, 4)),
    "roi_lossless": dict(roi=(0, 6)),
    "roi_layers_97": dict(roi=(1, 3), irreversible=True, layers=[3, 1.5]),
    "poc": dict(resolutions=3, layers=[3, 1.5, 1.2], pocs=[
        (0, 0, 2, 2, 3, "RLCP", 1), (1, 0, 3, 3, 3, "CPRL", 1)]),
    "poc_components": dict(resolutions=2, pocs=[
        (0, 1, 1, 2, 3, "LRCP", 1), (0, 0, 1, 2, 1, "RPCL", 1)]),
    "sampling_420": dict(sampling=[(1, 1), (2, 2), (2, 2)], mct=False),
    "sampling_odd": dict(sampling=[(1, 1), (1, 3), (3, 2)], mct=False,
                         tiles=(9, 7)),
    "sampling_all": dict(sampling=[(2, 1), (2, 1), (2, 1)], mct=False),
    "sampling_jp2_srgb": dict(sampling=[(1, 1), (2, 2), (2, 2)], mct=False,
                              jp2=True, colour=1),
    "offsets_tiles": dict(image_offset=(7, 3), tiles=(6, 5),
                          tile_offset=(2, 1)),
    "offsets_97": dict(image_offset=(5, 9), tiles=(16, 16),
                       tile_offset=(4, 8), irreversible=True),
    "tile_parts_R": dict(tiles=(8, 8), tile_parts="R", layers=[3, 1.5],
                         resolutions=2),
    "tile_parts_L": dict(tiles=(8, 8), tile_parts="L", layers=[3, 1.5],
                         resolutions=2),
    "tile_parts_C": dict(tiles=(8, 8), tile_parts="C", resolutions=2),
    "sop_eph_plt_tlm": dict(sop=True, eph=True, plt=True, tlm=True,
                            layers=[3, 1.5]),
    "precincts": dict(precincts=[(15, 15), (4, 4), (3, 3)], resolutions=3,
                      codeblock=(4, 4), progression="PCRL"),
    "four_components": dict(mct=True),
}


@pytest.mark.parametrize("case", sorted(_ENCODER_CASES))
def test_openjpeg_encoder_cases_match_jax(tmp_path, case):
    """Codestreams OpenJPEG's encoder writes with settings Pillow's save
    cannot set decode to JAX's pixels."""
    rng = np.random.default_rng(sorted(_ENCODER_CASES).index(case))
    kw = dict(_ENCODER_CASES[case])
    sampling = kw.get("sampling", [(1, 1)] * (
        4 if case == "four_components" else 3))
    planes = _planes(rng, sampling, 13, 17, off=kw.get("image_offset",
                                                       (0, 0)))
    if case.startswith("style_") or case.startswith("roi"):
        planes = [(p // 32) * 32 + rng.integers(0, 4, p.shape)
                  for p in planes]
    _same_as_jax(tmp_path, j2k_encode(planes, **kw))


@pytest.mark.parametrize("prec", range(1, 17))
def test_every_precision_matches_jax(tmp_path, prec):
    """Grey and RGB codestreams of each precision, unsigned and signed
    (Pillow shifts each to 8 bits, or 16 for I;16, with its rounding and
    wrapping)."""
    rng = np.random.default_rng(100 + prec)
    for n in (1, 3):
        for signed in (False, True):
            planes = _planes(rng, [(1, 1)] * n, 5, 7, prec, signed)
            _same_as_jax(tmp_path, j2k_encode(planes, precision=prec,
                                              signed=signed))


@pytest.mark.parametrize("where", ["ppt", "ppm"])
def test_packed_packet_headers_match_jax(tmp_path, where):
    """A tiled, layered codestream with its packet headers moved into PPT
    or PPM markers decodes as the original does."""
    rng = np.random.default_rng(7)
    planes = _planes(rng, [(1, 1)] * 3, 19, 21)
    marked = j2k_encode(planes, sop=True, eph=True, tiles=(8, 8),
                        resolutions=2, layers=[4, 1.5])
    want = _same_as_jax(tmp_path, marked, "marked.j2k")
    got = _same_as_jax(tmp_path, mt.packed_headers(marked, where))
    np.testing.assert_array_equal(got, want)


def _jp2_cases():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 7, (6, 9))
    grey = j2k_encode([idx], precision=3)
    pal = rng.integers(0, 256, (7, 3))
    pal[5] = pal[2]
    rgb = j2k_encode(_planes(rng, [(1, 1)] * 3, 6, 9))
    cmap3 = [(0, 1, c) for c in range(3)]
    many = rng.integers(0, 256, (300, 3))
    return {
        "pclr": mt.jp2_file(grey, pclr=(pal, (7, 7, 7)), cmap=cmap3),
        "pclr_wide_entries_past_the_end": mt.jp2_file(
            j2k_encode([rng.integers(0, 256, (6, 9))]),
            pclr=(pal, (7, 7, 7)), cmap=cmap3),
        "pclr_over_256_colours": mt.jp2_file(
            j2k_encode([rng.integers(0, 256, (6, 9))]),
            pclr=(many, (7, 7, 7)), cmap=cmap3),
        "pclr_grey_colr": mt.jp2_file(grey, pclr=(pal, (7, 7, 7)),
                                      cmap=cmap3, colr=((1, 17),)),
        "pclr_16_bit_columns": mt.jp2_file(grey, pclr=(pal, (15, 7, 7)),
                                           cmap=cmap3),
        "pa": mt.jp2_file(j2k_encode([idx, rng.integers(0, 8, (6, 9))],
                                     precision=3),
                          pclr=(pal, (7, 7, 7)), cmap=cmap3),
        "no_colr": mt.jp2_file(rgb, colr=()),
        "icc": mt.jp2_file(rgb, colr=((2, b"an ICC profile"),)),
        "colr14_lab": mt.jp2_file(rgb, colr=((1, 14),)),
        "colr24_eycc": mt.jp2_file(rgb, colr=((1, 24),)),
        "colr17_of_rgb": mt.jp2_file(rgb, colr=((1, 17),)),
        "colr16_of_grey": mt.jp2_file(grey, colr=((1, 16),)),
        "cdef_and_bpcc": mt.jp2_file(rgb, cdef=[(0, 0, 3), (1, 0, 2),
                                               (2, 0, 1)],
                                     ihdr=(6, 9, 3, 255), bpcc=(7, 7, 7)),
        "ihdr_of_one_component": mt.jp2_file(rgb, ihdr=(6, 9, 1, 7)),
        "ihdr_of_four_components": mt.jp2_file(rgb, ihdr=(6, 9, 4, 7)),
        "ihdr_of_16_bits": mt.jp2_file(rgb, ihdr=(6, 9, 3, 15)),
        "ihdr_size_not_the_siz": mt.jp2_file(rgb, ihdr=(7, 9, 3, 7)),
        "no_ihdr": mt.jp2_file(rgb, ihdr=False),
        "res": mt.jp2_file(rgb, res=True),
    }


@pytest.mark.parametrize("case", sorted(_jp2_cases()))
def test_jp2_boxes_match_jax(tmp_path, case):
    """JP2 files wrapped by hand: palettes (repeated colours, indices past
    the entries, too many colours, a grey colr), cmap, cdef, bpcc, each colr
    kind, ihdr boxes that disagree with the codestream, no ihdr, res."""
    _same_as_jax(tmp_path, _jp2_cases()[case])


_CUT_FIXTURES = ["j2k_pillow_rgb_5x7.j2k", "j2k_pillow_97_layers_13x15.j2k",
                 "j2k_pillow_tiles_11x13.j2k", "jp2_pillow_rgb_5x7.jp2",
                 "j2k_tile_parts_C_9x11.j2k", "j2k_sop_eph_9x11.j2k",
                 "j2k_ppm_9x11.j2k", "jp2_pclr_repeated_5x7.jp2"]


@pytest.mark.parametrize("name", _CUT_FIXTURES)
def test_cut_files_match_jax(tmp_path, name):
    """Files cut at several offsets, from the header into the last
    packet, and tile-parts of Psot 0 cut inside their packets and closed by
    an EOC: the port gives Pillow's pixels or raises a ValueError naming
    JPEG 2000, as OpenJPEG's strict mode refuses a cut stream."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    cuts = sorted({2, 13, len(data) - 1, len(data) - 2, len(data) - 3,
                   *rng.integers(4, len(data), 10).tolist()})
    for cut in cuts:
        _same_as_jax(tmp_path, data[:cut], f"cut{cut}.bin")
    start = data.index(jpeg2000.J2K_MAGIC) if name.endswith(".jp2") else 0
    sot = data.index(b"\xff\x90", start)
    if struct.unpack_from(">B", data, sot + 11)[0] == 1:
        psot0 = data[:sot + 6] + bytes(4) + data[sot + 10:]
        for cut in range(sot + 14, len(data) - 2, max(1, len(data) // 25)):
            _same_as_jax(tmp_path, psot0[:cut] + b"\xff\xd9", f"eoc{cut}.bin")


@pytest.mark.parametrize("name", J2K_FIXTURES[::2])
def test_flipped_bytes_match_jax(tmp_path, name):
    """Fixtures with seeded bytes changed: the port gives Pillow's pixels or
    raises a ValueError naming JPEG 2000, never other pixels; where Pillow
    gives pixels and the port raises, the reason is one of the known gaps
    (a Part 2 marker or an HTJ2K one)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(data) + 1)
    for k in range(30):
        b = bytearray(data)
        for pos in rng.integers(0, len(data), 1 + k % 3):
            b[pos] = int(rng.integers(0, 256))
        path = str(tmp_path / f"flip{k}.bin")
        with open(path, "wb") as f:
            f.write(bytes(b))
        try:
            want = _jax_u8(path)
        except Exception:
            want = None
        try:
            got = _port_u8(path)
        except ValueError as e:
            if want is not None:
                assert __import__("re").search(KNOWN_GAPS, str(e)), str(e)
            continue
        assert want is not None, f"Pillow refuses {k}, the port decodes it"
        np.testing.assert_array_equal(got, want)


def _with_marker(codestream: bytes, marker: int, body: bytes) -> bytes:
    """A marker segment put in the main header right after SIZ."""
    lsiz = struct.unpack_from(">H", codestream, 4)[0]
    at = 4 + lsiz
    return (codestream[:at] + struct.pack(">HH", marker, 2 + len(body))
            + body + codestream[at:])


def _refusals():
    rng = np.random.default_rng(9)
    rgb = j2k_encode(_planes(rng, [(1, 1)] * 3, 6, 9))
    cod = rgb.index(b"\xff\x52")
    ht = bytearray(rgb)
    ht[cod + 12] |= 0x40                    # SPcod's code-block style
    prog = bytearray(rgb)
    prog[cod + 5] = 9                       # SGcod's progression order
    eph = j2k_encode(_planes(rng, [(1, 1)] * 3, 6, 9), eph=True)
    no_eph = eph.replace(b"\xff\x92", b"\xff\x00", 1)
    five = j2k_encode(_planes(rng, [(1, 1)] * 5, 6, 9), mct=False)
    many = rng.integers(0, 256, (300, 3))
    return {
        "htj2k_cap": (_with_marker(rgb, 0xFF50, bytes(6)), r"HTJ2K.*CAP"),
        "htj2k_code_blocks": (bytes(ht), r"HTJ2K.*code-blocks"),
        **{f"part2_{m.lower()}": (_with_marker(rgb, code, bytes(4)),
                                  rf"Part 2.*{m} marker")
           for m, code in (("MCT", 0xFF74), ("MCC", 0xFF75), ("MCO", 0xFF77),
                           ("CBD", 0xFF78), ("ATK", 0xFF79),
                           ("ADS", 0xFF73))},
        "unknown_progression": (bytes(prog), r"unknown progression order 9"),
        "missing_eph": (no_eph, r"EPH marker"),
        "five_components_j2k": (five, r"JPEG 2000.*unable to determine J2K "
                                      r"image mode"),
        "five_components_jp2": (mt.jp2_file(five), r"malformed JP2 header"),
        "no_ihdr": (mt.jp2_file(rgb, ihdr=False), r"malformed JP2 header"),
        "palette_over_256": (mt.jp2_file(
            j2k_encode([rng.integers(0, 256, (6, 9))]),
            pclr=(many, (7, 7, 7)), cmap=[(0, 1, c) for c in range(3)]),
            r"more than 256 distinct colours"),
        "ihdr_size": (mt.jp2_file(rgb, ihdr=(7, 9, 3, 7)),
                      r"ihdr box's 9x7 is not the SIZ marker's 9x6"),
        "grey_colr_of_rgb": (mt.jp2_file(rgb, colr=((1, 17),)),
                             r"RGB image of 3 grey components: Pillow has no "
                             r"unpacker"),
        "cut_stream": (rgb[:-3], r"cut short"),
        "no_eoc": (rgb[:-2], r"cut short \(no EOC\)"),
        "tile_part_order": (_tile_part_out_of_order(rgb),
                            r"tile-part 1 of tile 0 out of order"),
    }


def _tile_part_out_of_order(codestream: bytes) -> bytes:
    sot = codestream.index(b"\xff\x90")
    return codestream[:sot + 10] + b"\x01" + codestream[sot + 11:]


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_name_their_case(tmp_path, case):
    """Each refusal raises a ValueError naming JPEG 2000 and its case: the
    Part 15 and Part 2 streams the port does not decode (Pillow decodes the
    CAP and MCT-marker ones, ROADMAP queue 3), and what Pillow refuses too
    (held to Pillow by _same_as_jax)."""
    data, words = _refusals()[case]
    path = str(tmp_path / "refused.j2k")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=words) as e:
        mesh_io.load_image(path)
    assert "JPEG 2000" in str(e.value)
    if not case.startswith(("htj2k", "part2")):
        with pytest.raises(Exception):
            _jax_u8(path)


def _idwt53_twin(coef, x0, y0, sw, sh):
    """A numpy twin of one level of the inverse 5/3 transform (ITU-T T.800
    F.3.8.1 with symmetric extension; a lone odd sample halved by C
    division), rows first, then columns."""
    def lift(lo, hi, cas):
        n = len(lo) + len(hi)
        if n == 1:
            return np.array([int(np.fix(hi[0] / 2))]) if cas else lo.copy()
        x = np.zeros(n, np.int64)
        x[cas::2], x[1 - cas::2] = lo, hi
        idx = np.arange(n)

        def at(i):
            i = np.abs(i)
            return x[np.where(i >= n, 2 * (n - 1) - i, i)]

        even = idx[cas::2]
        x[even] -= (at(even - 1) + at(even + 1) + 2) >> 2
        odd = idx[1 - cas::2]
        x[odd] += (at(odd - 1) + at(odd + 1)) >> 1
        return x

    out = coef.astype(np.int64).copy()
    h, w = out.shape
    for j in range(h):
        out[j] = lift(out[j, :sw], out[j, sw:], x0 % 2)
    for i in range(w):
        out[:, i] = lift(out[:sh, i], out[sh:, i], y0 % 2)
    return out


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (3, 5), (8, 7),
                                   (17, 16), (2, 33)])
def test_native_idwt53_and_rct_against_numpy_twin(shape):
    """native.j2k_idwt53 (the decoder's own transform) equals the numpy
    twin of the inverse 5/3 transform at each origin parity, and its RCT the
    standard's G = Y - floor((U + V) / 4), R = V + G, B = U + G."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    h, w = shape
    for x0 in (0, 1):
        for y0 in (0, 1):
            sw = -(-(x0 + w) // 2) - -(-x0 // 2)
            sh = -(-(y0 + h) // 2) - -(-y0 // 2)
            coef = rng.integers(-3000, 3000, (3, h, w))
            got = native.j2k_idwt53(coef, x0, y0, (sw, sh))
            want = np.stack([_idwt53_twin(c, x0, y0, sw, sh) for c in coef])
            np.testing.assert_array_equal(got, want)
            got = native.j2k_idwt53(coef, x0, y0, (sw, sh), rct=True)
            y, u, v = want
            g = y - ((u + v) >> 2)
            np.testing.assert_array_equal(got, np.stack([v + g, g, u + g]))


def test_dispatch_and_formats():
    """JPEG 2000 decodes in Pillow's plugin order, and format_of names
    it; a file whose first bytes are JPEG 2000's but whose header Pillow
    cannot open goes on to the next format and is refused by name."""
    assert "JPEG 2000" in image_io.READ and "ICNS" in image_io.READ
    with open(os.path.join(FIXTURES, J2K_FIXTURES[0]), "rb") as f:
        data = f.read()
    assert image_io.format_of(data) == "JPEG 2000"
    with pytest.raises(ValueError, match=r"JPEG 2000: .*not opened"):
        image_io.decode_image(jpeg2000.J2K_MAGIC + b"\x00")
