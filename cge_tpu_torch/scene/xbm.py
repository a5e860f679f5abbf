"""XBM textures (X11 bitmaps) without Pillow, as Pillow 12's XbmImagePlugin
reads them and `convert("RGB")` converts them (the JAX package's loader).

The header is Pillow's regular expression over the file's first 512 bytes
only: optional whitespace, a "#define ..._width N" line, a "#define
..._height N" line, an optional hotspot ("_x_hot" and "_y_hot" lines),
then anything up to the last "_bits[]" in those bytes, where the data
start. The data are read as Pillow's C decoder (XbmDecode.c) reads them,
in the native library's cge_raster.cpp: each byte from the two characters
after the next 'x' (a character that is no hex digit reads 0), a row of
ceil(width / 8) bytes, least significant bit first, a set bit white (255)
and a clear one black. A header the expression does not match (a file cut
or padded past 512 bytes before "_bits[]") raises native.NotOpened, as
Pillow's plugin cannot open it; data that end before the last row raise
a ValueError naming XBM.
"""

from __future__ import annotations

import re

import numpy as np

from cge_tpu_torch import native

# XbmImagePlugin.xbm_head
HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def accept(data: bytes) -> bool:
    """XbmImagePlugin's test of the first 16 bytes (Image.open's prefix):
    "#define" after any whitespace."""
    return data[:16].lstrip().startswith(b"#define")


def decode_xbm(data: bytes) -> np.ndarray:
    """XBM bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    m = HEAD.match(data[:512])
    if not m:
        raise native.NotOpened("not a XBM file (no width, height and _bits[] "
                               "in its first 512 bytes)")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"XBM of {w}x{h} pixels")
    native.check_pixels("XBM", w, h)
    stride = (w + 7) // 8
    rows = native.xbm_bytes(data, m.end(), stride * h).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)
