"""Probes of the two reads of Pillow 12's JpegImagePlugin that can keep a
JPEG from opening after its marker walk: _read_dpi_from_exif (an APP1 Exif
segment's IFD0 ResolutionUnit and XResolution, read through
ImageFileDirectory_v2) and jpeg_factory's _getmp (an APP2 MPF segment's
NumberOfImages and MP entries). Seeded 8x8 JPEGs with such segments go
through the port's image_io.decode_image and Pillow's
Image.open(...).convert("RGB"): the same pixels, or both refusing.

The EXIF cases cover every field type (0-18) and counts 0-3 of
XResolution, random values (ASCII with and without NULs), out-of-line
values cut by the segment's end, with and without ResolutionUnit and a
JFIF APP0 of each density unit, directories cut short, several Exif
segments, both byte orders and headers Pillow does not take. The MPF
cases cover every type and count of NumberOfImages and MPEntry, entries
of each image data format, cut directories, Ultra HDR APP1 segments and
both byte orders.

    JAX_PLATFORMS=cpu python3 jax_references/jpeg_segment_probes.py [N]

N files a kind (default 3000). It prints each mismatch and the counts
(files Pillow opens, files both refuse, mismatches).
"""

from __future__ import annotations

import functools
import io
import os
import struct
import sys
import warnings

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402

from cge_tpu_torch.scene import image_io  # noqa: E402
from jax_references import make_textures as mt  # noqa: E402

_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _value(rng, typ: int, count: int, small: bool = False) -> bytes:
    """count values of field type typ: ASCII digits and NULs, or random
    bytes; small: numbers from 0 to 3."""
    size = count * _SIZES.get(typ, 1)
    if typ == 2:
        return bytes(rng.choice(list(b"0127\0x"), size).tolist())
    if small and typ in (3, 4, 6, 8, 9, 13, 16, 17):
        code = {3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q",
                17: "q"}[typ]
        return struct.pack("<" + code * count,
                           *rng.integers(-1 if code.islower() else 0, 4,
                                         count).tolist())
    return rng.integers(0, 256, size).astype(np.uint8).tobytes()


def _entry(rng, tag: int, small: bool = False) -> tuple:
    typ = int(rng.choice([1, 2, 3, 4, 5, 7, 7, 2, 2, 1, 6, 8, 9, 10, 11,
                          12, 13, 16, 17, 18, 0, 14, 19]))
    count = int(rng.choice([0, 1, 1, 2, 2, 3, 3, 5, 20, 40]))
    value = _value(rng, typ, count, small)
    if rng.random() < 0.05 and len(value) > 4:
        return tag, typ, count, 5000                # out of line, past it
    return tag, typ, count, value


def exif_case(rng, base: bytes) -> bytes:
    entries = []
    if rng.random() < 0.8:
        entries.append(_entry(rng, 0x0128, small=True))
    if rng.random() < 0.9:
        entries.append(_entry(rng, 0x011A))
    for _ in range(int(rng.integers(0, 3))):
        entries.insert(int(rng.integers(0, len(entries) + 1)),
                       _entry(rng, int(rng.integers(256, 300))))
    order = "<" if rng.random() < 0.6 else ">"
    seg = mt.exif_segment(entries, order)[1]
    r = rng.random()
    if r < 0.1:
        seg = seg[:int(rng.integers(6, len(seg) + 1))]
    elif r < 0.15:
        seg = b"Exif\0\0" + seg
    elif r < 0.2:
        seg = seg[:8] + bytes((43,)) + seg[9:]      # BigTIFF's version
    elif r < 0.25:
        seg = seg[:6] + b"XX" + seg[8:]
    segments = [(0xE1, seg)]
    if rng.random() < 0.1:
        segments.append((0xE1, b"Exif\0\0" + rng.integers(
            0, 256, int(rng.integers(0, 30))).astype(np.uint8).tobytes()))
    jfif = rng.random() < 0.4
    data = mt.jpeg_with_segments(base, segments, jfif=jfif)
    if jfif:
        unit = int(rng.choice([0, 1, 2, 3]))
        data = data[:13] + bytes((unit,)) + data[14:]
    return data


def mpf_case(rng, base: bytes) -> bytes:
    order = "<" if rng.random() < 0.6 else ">"
    entries = []
    if rng.random() < 0.9:
        tag, typ, count, value = _entry(rng, 0xB001, small=True)
        if rng.random() < 0.5:
            typ, count = 4, 1
            value = struct.pack(order + "I", int(rng.choice([0, 1, 2, 3])))
        entries.append((tag, typ, count, value))
    if rng.random() < 0.9:
        tag, typ, count, value = _entry(rng, 0xB002)
        if rng.random() < 0.6:
            n = int(rng.integers(0, 4))
            value = mt.mp_entries([(0, 100)] * n, order,
                                  int(rng.choice([0, 0, 0, 1, 2])))
            value += bytes(int(rng.choice([0, 0, 4, 15])))
            value = value[:len(value) - int(rng.choice([0, 0, 0, 3, 16]))]
            typ, count = int(rng.choice([7, 7, 1, 2, 4])), len(value)
            if typ == 4:
                count //= 4
                value = value[:4 * count]
        entries.append((tag, typ, count, value))
    if rng.random() < 0.3:
        entries.insert(0, (0xB000, 7, 4, b"0100"))
    head = None
    if rng.random() < 0.1:
        head = (b"MM*\0" if order == ">" else b"II\0*") + struct.pack(
            order + "I", 8)
    seg = mt.mpf_segment(entries, order, head)[1]
    if rng.random() < 0.1:
        seg = seg[:int(rng.integers(4, len(seg) + 1))]
    segments = [(0xE2, seg)]
    if rng.random() < 0.2:
        segments.insert(int(rng.integers(0, 2)), (0xE1, b"http://ns.adobe."
                        b"com/xap/1.0/\0<x hdrgm:Version=\"1.0\"/>"))
    if rng.random() < 0.1:
        segments.insert(0, (0xE2, b"MPF\0II*\0\x08\0\0\0\0\0"))
    return mt.jpeg_with_segments(base, segments)


@functools.cache
def pillow_base() -> bytes:
    """The 8x8 Pillow JPEG (seed 29, quality 90) the cases are made of."""
    rng = np.random.default_rng(29)
    return mt._pillow(PILImage.fromarray(rng.integers(
        0, 256, (8, 8, 3)).astype(np.uint8)), "JPEG", quality=90)


def pillow(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with PILImage.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception as e:
        return type(e).__name__


def port(data: bytes):
    try:
        return image_io.decode_image(data)
    except ValueError as e:
        return str(e)


def main(argv) -> int:
    n = int(argv[0]) if argv else 3000
    rng = np.random.default_rng(30)
    base = pillow_base()
    bad = 0
    for kind, case in (("exif", exif_case), ("mpf", mpf_case)):
        opened = refused = wrong = 0
        for i in range(n):
            data = case(rng, base)
            want, got = pillow(data), port(data)
            if isinstance(want, str) and isinstance(got, str):
                refused += 1
            elif isinstance(want, str) or isinstance(got, str) or \
                    not np.array_equal(want, got):
                wrong += 1
                print(f"{kind} {i}: Pillow "
                      f"{want if isinstance(want, str) else 'pixels'}, port "
                      f"{got if isinstance(got, str) else 'pixels'}: "
                      f"{data[:120].hex()}")
            else:
                opened += 1
        print(f"{kind}: {opened} opened, {refused} refused by both, "
              f"{wrong} mismatches")
        bad += wrong
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
