"""XV thumbnails (the .xvpics files of the XV image viewer) without
Pillow, as Pillow 12's XVThumbImagePlugin reads them and
`convert("RGB")` converts them (the JAX package's loader).

The magic "P7 332", the rest of that line passed over, then any lines that
start with '#', then a line whose first two whitespace-separated fields
are the width and height, read by Python's int() (so "+2" and "1_0"
read too). The data follow that line: a byte a pixel, indices into
Pillow's fixed RGB332 palette (red (i >> 5) * 255 // 7, green
((i >> 2) & 7) * 255 // 7, blue (i & 3) * 255 // 3).

The end of the file before the size line is Pillow's SyntaxError, as is
an empty image: native.NotOpened, so Image.open goes on to the next
format. A size line of fewer than two fields or a field int() refuses, and
data cut short, raise a ValueError naming XV thumbnail.
"""

from __future__ import annotations

import numpy as np

from cge_tpu_torch import native

MAGIC = b"P7 332"
_I = np.arange(256)
# XVThumbImagePlugin.PALETTE
PALETTE = np.stack([(_I >> 5) * 255 // 7, (_I >> 2 & 7) * 255 // 7,
                    (_I & 3) * 255 // 3], axis=1).astype(np.uint8)


def accept(data: bytes) -> bool:
    return data[:6] == MAGIC


def _line(data: bytes, pos: int) -> tuple[bytes, int]:
    """Python's readline from pos: the bytes up to and with the next
    newline, or to the end."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def open_xvthumb(data: bytes) -> tuple:
    """XV thumbnail bytes -> the image as Pillow opens it: P of the 3-3-2
    palette (modes.rgb converts it)."""
    if not accept(data):
        raise ValueError("not an XV thumbnail (no P7 332 magic)")
    _, pos = _line(data, len(MAGIC))
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise native.NotOpened("XV thumbnail ends before its size line")
        if s[0] != ord("#"):
            break
    fields = s.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise ValueError(f"XV thumbnail size line {s!r} of fewer than two "
                         f"fields")
    try:
        w, h = int(fields[0]), int(fields[1])
    except ValueError:
        raise ValueError(f"XV thumbnail size line {s!r}: not two integers") \
            from None
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"XV thumbnail of {w}x{h} pixels")
    fmt = "XV thumbnail"
    native.check_pixels(fmt, w, h)
    return "P", native.raw_rows(data, pos, h, w, w, fmt), PALETTE
