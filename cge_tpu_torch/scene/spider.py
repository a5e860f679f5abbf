"""SPIDER images (electron microscopy) without Pillow, as Pillow 12's
SpiderImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

SPIDER has no signature: Image.open tries the plugin on every file that
reaches it (after SGI, before Sun raster). Its header is read as 27
floats, big-endian and, where that is no header, little-endian, numbered
from 1: a header has whole numbers at 1, 2, 5, 12, 13, 22 and 23, the
iform (5) one of 1, 3, -11, -12, -21 and -22, and labbyt (22) = labrec
(13) x lenbyt (23), not 0; labbyt is the header's length. Only iform 1 is
an image, nsam (12) by nrow (2) float32 samples of the header's byte
order, rows from the top, at the header's end: a plain image (istack 24
and imgnumber 27 both 0), or the first image of a stack (istack above 0,
imgnumber 0), after a second header. The samples are clamped and
truncated to 8 bits, a NaN refused (modes.py).

A file of fewer than 108 bytes, no header, another iform, inconsistent
stack values and an empty image are not SPIDER files to Pillow
(native.NotOpened). What escapes Image.open raises a ValueError naming
SPIDER: an image within a stack opened alone (Pillow's missing
stkoffset), an istack, imgnumber or stack count int() refuses (NaN,
infinity), a negative offset, data cut short.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

HEADER = 27 * 4
IFORMS = (1, 3, -11, -12, -21, -22)


def _whole(f: float) -> bool:
    """SpiderImagePlugin.isInt."""
    return math.isfinite(f) and f == int(f)


def _header_length(t: tuple) -> int:
    """isSpiderHeader: the header's length, 0 where t is no header."""
    h = (99,) + t
    if not all(_whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def header(data: bytes) -> tuple:
    """SpiderImageFile._open and the mode and size checks: (width, height,
    offset, big-endian); native.NotOpened where Pillow's plugin does not
    open the file, ValueError where it raises what escapes Image.open."""
    if len(data) < HEADER:
        raise native.NotOpened(f"SPIDER header of {len(data)} bytes")
    for big in (True, False):
        t = struct.unpack_from(">27f" if big else "<27f", data)
        length = _header_length(t)
        if length:
            break
    else:
        raise native.NotOpened("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise native.NotOpened(f"not a Spider 2D image (iform {int(h[5])})")
    width, height = int(h[12]), int(h[2])
    try:
        istack, number = int(h[24]), int(h[27])
        if istack == 0 and number == 0:
            offset = length
        elif istack > 0 and number == 0:
            int(h[26])                          # the stack's image count
            offset = 2 * length
        elif istack == 0 and number > 0:
            raise ValueError("an image within a stack, opened alone (Pillow's "
                             "plugin has no stack offset for it)")
        else:
            raise native.NotOpened(f"inconsistent stack header values "
                                   f"(istack {istack}, imgnumber {number})")
    except OverflowError as e:
        raise ValueError(f"SPIDER header value: {e}") from None
    if width <= 0 or height <= 0:
        raise native.NotOpened(f"SPIDER of {width}x{height} pixels")
    return width, height, offset, big


def decode_spider(data: bytes) -> np.ndarray:
    """SPIDER bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    width, height, offset, big = header(data)
    fmt = f"SPIDER ({'big' if big else 'little'}-endian)"
    native.check_pixels(fmt, width, height)
    if offset < 0:
        raise ValueError(f"{fmt}: its data offset {offset} is negative")
    rows = native.raw_rows(data, offset, height, 4 * width, 4 * width, fmt)
    px = rows.view(">f4" if big else "<f4")
    return modes.grey(modes.f_to_u8(px, fmt))
