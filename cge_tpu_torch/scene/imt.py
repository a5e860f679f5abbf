"""IM Tools images without Pillow, as Pillow 12's ImtImagePlugin reads
them and `convert("RGB")` converts them (the JAX package's loader).

IM Tools has no signature: Image.open tries the plugin on every file that
reaches it (after IM, before IPTC). Its header is read as Pillow reads it,
from a buffer of the file's first 100 bytes (which must hold a newline)
topped up by 100 bytes where it holds no newline: each line a "key value"
pair of Pillow's `field` expression (lower-case letters, a space, a value
up to the next space), lines starting with '*' comments; "width" and
"height" are read by Python's int(), "pixel n8" makes the image L. A form
feed ends the header, the grey bytes following it, rows from the top. A
line of one byte or over 100, or one that is no pair, ends the header
without an image.

A header without a newline in its first 100 bytes, a mode or a size is not
an IM Tools file to Pillow (native.NotOpened). What escapes Image.open
raises a ValueError naming IMT: a width or height int() refuses ("width
abc"), a header that ends before its form feed (no image to load), a size
past Pillow's limit, data cut short.
"""

from __future__ import annotations

import re

import numpy as np

from cge_tpu_torch import native

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def header(data: bytes) -> tuple:
    """ImtImageFile._open and the checks after it: (width, height, the data
    offset or None where no form feed ended the header)."""
    buf, pos = data[:100], min(100, len(data))
    if b"\n" not in buf:
        raise native.NotOpened("not an IM Tools file (no newline in its "
                               "first 100 bytes)")
    w = h = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buf:
            s, buf = buf[:1], buf[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buf)
            break
        if b"\n" not in buf:
            buf += data[pos:pos + 100]
            pos = min(pos + 100, len(data))
        line, _, buf = buf.partition(b"\n")
        s += line
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
                size = w, h
            elif k == b"height":
                h = int(v)
                size = w, h
        except ValueError as e:
            raise ValueError(f"IM Tools header {k.decode()} {v!r}: {e}") \
                from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise native.NotOpened(f"IM Tools header of mode {mode!r} and size "
                               f"{size}")
    return size[0], size[1], offset


def open_imt(data: bytes) -> tuple:
    """IM Tools bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): L."""
    w, h, offset = header(data)
    fmt = "IMT (IM Tools, L)"
    native.check_pixels(fmt, w, h)
    if offset is None:
        raise ValueError(f"{fmt}: its header ends before a form feed, so "
                         f"Pillow has no image to load (cannot load this "
                         f"image)")
    return "L", native.raw_rows(data, offset, h, w, w, fmt), None
