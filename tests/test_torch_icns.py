"""The port's ICNS reader (cge_tpu_torch/scene/icns.py; the run-length
channels in native/cge_raster.cpp) against Pillow 12's IcnsImagePlugin,
which the JAX package's loader uses: the fixtures, icons of PNG, JPEG 2000
(J2K and JP2 in each mode), raw and run-length entries with and without
masks, several sizes in one file, entries of sizes the file does not
declare, files cut at several lengths, every refusal, and the dispatch in
Pillow's order. Pixels must be equal exactly (u8 / 255 as float32, as the
JAX loader gives them)."""

import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import icns, image_io, mesh_io
from jax_references import make_textures as mt
from jax_references.j2k_encoder import j2k_encode

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_textures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    ICNS_FIXTURES = [f["name"] for f in json.load(_f)["files"]
                     if f["kind"] == "icns"]


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="icon.bin"):
    """The port's pixels equal JAX's; where JAX's loader (Pillow) raises,
    the port raises a ValueError that names the file and the format of the
    file's first bytes. JAX's pixels, or None."""
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


def _saved(img, fmt, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _icons():
    """(name, ICNS bytes) of each kind of entry and mode."""
    rng = np.random.default_rng(230)
    out = []
    for side, kind in ((16, b"icp4"), (32, b"icp5"), (64, b"icp6"),
                       (16, b"ic11"), (32, b"ic12")):
        img = PIL.fromarray(rng.integers(0, 256, (side, side, 3)).astype(
            np.uint8))
        for mode in ("L", "LA", "RGB", "RGBA", "P"):
            out.append((f"png_{kind.decode()}_{mode}",
                        mt.icns_file([(kind, _saved(img.convert(mode),
                                                    "PNG"))])))
        for mode in ("L", "LA", "RGB", "RGBA"):
            for opts in ({}, {"no_jp2": True},
                         {"irreversible": True, "quality_layers": [20]}):
                tag = "_".join(f"{k}" for k in opts) or "jp2"
                out.append((f"j2k_{kind.decode()}_{mode}_{tag}", mt.icns_file(
                    [(kind, _saved(img.convert(mode), "JPEG2000", **opts))])))
    grey16 = PIL.fromarray(rng.integers(0, 700, (32, 32)).astype(np.uint16))
    out.append(("j2k_i16", mt.icns_file([(b"icp5", _saved(grey16,
                                                          "JPEG2000"))])))
    idx = rng.integers(0, 6, (32, 32))
    pal = rng.integers(0, 256, (6, 3))
    cmap = [(0, 1, c) for c in range(3)]
    out.append(("jp2_palette", mt.icns_file([(b"icp5", mt.jp2_file(
        j2k_encode([idx], precision=3), pclr=(pal, (7, 7, 7)),
        cmap=cmap))])))
    out.append(("jp2_palette_alpha", mt.icns_file([(b"icp5", mt.jp2_file(
        j2k_encode([idx, rng.integers(0, 8, (32, 32))], precision=3),
        pclr=(pal, (7, 7, 7)), cmap=cmap))])))
    out.append(("jp2_cmyk", mt.icns_file([(b"icp5", mt.jp2_file(
        j2k_encode([rng.integers(0, 256, (32, 32)) for _ in range(4)],
                   mct=False), colr=((1, 12),)))])))
    for side, kind, mask in ((16, b"is32", b"s8mk"), (32, b"il32", b"l8mk"),
                             (48, b"ih32", b"h8mk"), (128, b"it32", b"t8mk")):
        px = (rng.integers(0, 4, (side, side // 8, 3)) * 80).astype(np.uint8)
        px = np.repeat(px, 8, axis=1)
        lead = kind == b"it32"
        out.append((f"runs_{kind.decode()}", mt.icns_file(
            [(kind, mt.icns_rgb(px, lead))])))
        out.append((f"runs_{kind.decode()}_mask", mt.icns_file(
            [(kind, mt.icns_rgb(px, lead)),
             (mask, rng.integers(0, 256, side * side).astype(
                 np.uint8).tobytes())])))
        out.append((f"raw_{kind.decode()}", mt.icns_file(
            [(kind, (bytes(4) if lead else b"") + px.tobytes())])))
    small = (rng.integers(0, 2, (16, 16, 3)) * 200).astype(np.uint8)
    big = _saved(PIL.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(
        np.uint8)), "PNG")
    out.append(("sizes_largest_wins", mt.icns_file(
        [(b"is32", mt.icns_rgb(small)), (b"icp5", big),
         (b"il32", mt.icns_rgb(np.repeat(np.repeat(small, 2, 0), 2, 1)))])))
    out.append(("png_of_another_size", mt.icns_file(
        [(b"icp5", _saved(PIL.fromarray(small), "PNG"))])))
    out.append(("png_not_a_size", mt.icns_file(
        [(b"icp5", _saved(PIL.fromarray(small[:, :8]), "PNG"))])))
    out.append(("png_twice_the_size", mt.icns_file([(b"icp4", big)])))
    return out


@pytest.mark.parametrize("name,data", _icons(), ids=[n for n, _ in _icons()])
def test_icons_match_jax(tmp_path, name, data):
    """Icons of every entry kind and mode decode to JAX's pixels (or are
    refused where Pillow refuses them: PNG entries of a size the file does
    not declare)."""
    _same_as_jax(tmp_path, data)


def _refusals():
    px = np.zeros((16, 16, 3), np.uint8)
    runs = mt.icns_rgb(px)
    return {
        "it32_without_its_lead": (mt.icns_file([(b"it32", mt.icns_rgb(
            np.zeros((128, 128, 3), np.uint8)))]), r"ICNS it32 entry without "
                                                  r"its zero lead"),
        "unknown_subimage": (mt.icns_file([(b"icp4", b"GIF89a" + bytes(30))]),
                             r"ICNS entry of an unsupported subimage format"),
        "mask_alone": (mt.icns_file([(b"s8mk", bytes(256))]),
                       r"ICNS size \(16, 16, 1\) with a mask but no colour"),
        "runs_overrun": (mt.icns_file([(b"is32", bytes((0xFF, 1, 0xFF, 1))
                                        + runs)]),
                         r"ICNS run-length channel 0: error reading channel "
                         r"\[-4 left\]"),
        "runs_cut": (mt.icns_file([(b"is32", runs)])[:-2],
                     r"ICNS run-length channel 2"),
        "mask_cut": (mt.icns_file([(b"is32", runs), (b"s8mk", bytes(10))]),
                     r"ICNS mask b's8mk' cut short"),
        "raw_cut": (mt.icns_file([(b"is32", px.tobytes())])[:-4],
                    r"ICNS run-length channel 0|ICNS raw RGB entry cut "
                    r"short"),
        "png_not_a_size": (mt.icns_file([(b"icp5", _saved(PIL.fromarray(
            np.zeros((16, 8, 3), np.uint8)), "PNG"))]),
            r"ICNS entry of 8x16 pixels: not one of the allowed sizes"),
        "jpeg2000_entry_not_opened": (mt.icns_file([(
            b"icp4", b"\x0d\x0a\x87\x0a" + bytes(20))]),
            r"ICNS JPEG 2000 entry: not a JPEG 2000 file"),
        "no_icon_entries": (mt.icns_file([(b"TOC ", bytes(8))]),
                            r"ICNS without 32-bit icon resources.*not "
                            r"opened"),
        "entry_list_cut": (b"icns" + struct.pack(">I", 64) + b"is32"
                           + struct.pack(">I", 8), r"ICNS entry header at "
                                                   r"16 cut short"),
        "empty_entry": (b"icns" + struct.pack(">I", 16) + b"is32" + bytes(4),
                        r"ICNS entry b'is32': invalid block header"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_name_their_case(tmp_path, case):
    """What Pillow refuses raises a ValueError naming ICNS and the case;
    Pillow refuses each too."""
    data, words = _refusals()[case]
    path = str(tmp_path / "refused.icns")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=words):
        mesh_io.load_image(path)
    with pytest.raises(Exception):
        _jax_u8(path)


@pytest.mark.parametrize("name", ICNS_FIXTURES)
def test_cut_icons_match_jax(tmp_path, name):
    """Fixtures cut at several lengths, from the header into the last
    entry: Pillow's pixels, or a ValueError naming the format."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    for cut in sorted({4, 8, 12, 17, len(data) - 1,
                       *rng.integers(18, len(data), 8).tolist()}):
        _same_as_jax(tmp_path, data[:cut], f"cut{cut}.icns")


def test_native_icns_rle_against_python_twin():
    """native.icns_rle equals a Python twin of read_32's loop on random
    run-length channels."""
    rng = np.random.default_rng(5)

    def twin(data, pos, n):
        out = []
        for _ in range(3):
            band, left = bytearray(), n
            while left > 0:
                b = data[pos]
                pos += 1
                if b & 0x80:
                    band += bytes((data[pos],)) * (b - 125)
                    pos += 1
                    left -= b - 125
                else:
                    band += data[pos:pos + b + 1]
                    pos += b + 1
                    left -= b + 1
            out.append(np.frombuffer(bytes(band), np.uint8))
        return np.stack(out, axis=1)

    for side in (16, 48):
        px = np.repeat(rng.integers(0, 3, (side, side // 4, 3)) * 90, 4,
                       axis=1).astype(np.uint8)
        px[::5] = rng.integers(0, 256, px[::5].shape)
        data = mt.icns_rgb(px)
        got = native.icns_rle(data, 0, side * side)
        np.testing.assert_array_equal(got, twin(data, 0, side * side))
        np.testing.assert_array_equal(got, px.reshape(-1, 3))


def test_dispatch_goes_on_past_an_icns_it_cannot_open():
    """An "icns" file whose entry list Pillow cannot read is not an ICNS
    image to it: Image.open tries the next formats, and so does the port,
    which names ICNS in the refusal."""
    data = b"icns" + struct.pack(">I", 40) + b"is32"
    assert image_io.format_of(data) == "ICNS"
    with pytest.raises(native.NotOpened):
        icns.decode_icns(data)
    with pytest.raises(ValueError, match=r"ICNS: .*not opened"):
        image_io.decode_image(data)
