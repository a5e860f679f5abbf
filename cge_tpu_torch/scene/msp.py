"""Windows Paint images (.msp) without Pillow, as Pillow 12's
MspImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

The 32-byte little-endian header: "DanM" (Paint 1.x) or "LinS" (Paint
2.x), the width and height at 4 and 6, and its sixteen words XOR to 0 (the
checksum word makes them). The image is bilevel, a set bit white, each row
ceil(width / 8) bytes, most significant bit first. "DanM" holds the rows
raw from offset 32. "LinS" holds a map of each row's encoded length (a
word a row) after the header, then the rows, read as Pillow's MspDecoder
reads them (native.msp_rle, in cge_raster.cpp): a row of length 0 is a
white row; in a row a byte 0 starts a run (a count, then the byte
repeated), any other byte n is n literal bytes, of which a row that ends
first gives what it holds. The decoded rows are joined into one stream
that is then read as the image's rows, so a row that decodes long or
short shifts the rows after it.

A header cut short, a checksum other than 0 or an empty image is not an
MSP file to Pillow, which goes on to the next format (native.NotOpened).
Data cut short (the raw rows, the row map, a row), a run cut after its
count, and a stream shorter than the image (Pillow's "not enough image
data") raise a ValueError naming MSP.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

HEADER = 32
MAGICS = (b"DanM", b"LinS")


def accept(data: bytes) -> bool:
    return data[:4] in MAGICS


def open_msp(data: bytes) -> tuple:
    """MSP bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): 1."""
    if not accept(data):
        raise ValueError("not an MSP file (no DanM or LinS magic)")
    if len(data) < HEADER:
        raise native.NotOpened(f"MSP header of {len(data)} bytes")
    words = np.frombuffer(data, "<u2", HEADER // 2)
    if np.bitwise_xor.reduce(words):
        raise native.NotOpened("MSP header whose checksum is not 0")
    w, h = int(words[2]), int(words[3])
    if not w or not h:
        raise native.NotOpened(f"MSP of {w}x{h} pixels")
    raw = data[:4] == b"DanM"
    fmt = f"MSP ({'Paint 1.x DanM' if raw else 'Paint 2.x LinS'})"
    native.check_pixels(fmt, w, h)
    stride = (w + 7) // 8
    if raw:
        rows = native.raw_rows(data, HEADER, h, stride, stride, fmt)
    else:
        if HEADER + 2 * h > len(data):
            raise ValueError(f"{fmt}: truncated in its row map")
        lengths = struct.unpack_from(f"<{h}H", data, HEADER)
        rows = native.msp_rle(data, HEADER + 2 * h, lengths, stride, fmt)
    bits = np.unpackbits(rows, axis=1)[:, :w]
    return "1", bits * np.uint8(255), None
