"""FTEX textures (.ftc, .ftu: the Mako engine's Texture File Format)
without Pillow, as Pillow 12's FtexImagePlugin reads them and
`convert("RGB")` converts them (the JAX package's loader).

The little-endian header: "FTEX", the version, width and height (signed),
the mipmap and format counts, then a format table entry (format, offset
of its first mipmap). At that offset: the mipmap's size and bytes. Format
0 is DXT1, through the BC1 path of native/cge_bcn.cpp that DDS takes
(Pillow's C BCn decoder); format 1 raw RGB.

What Pillow refuses raises a ValueError that names FTEX: a format count
other than 1, another format, a negative offset, a mipmap size below -1
(-1 reads the rest of the file) and a mipmap short of the image's blocks
or bytes. A header too short to read, an offset past the
file's end and an empty image are not an FTEX image to Pillow, which goes
on to the next format (native.NotOpened).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

MAGIC = b"FTEX"
FORMATS = {0: "DXT1", 1: "uncompressed"}


def accept(data: bytes) -> bool:
    return data[:4] == MAGIC


def decode_ftex(data: bytes) -> np.ndarray:
    """FTEX bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not accept(data):
        raise ValueError("not an FTEX file (no FTEX signature)")
    if len(data) < 24:
        raise native.NotOpened(f"FTEX header of {len(data)} bytes")
    w, h, _, count = struct.unpack_from("<4i", data, 8)
    if count != 1:
        raise ValueError(f"FTEX with {count} formats: Pillow reads files of "
                         f"one format only")
    if len(data) < 32:
        raise native.NotOpened(f"FTEX header of {len(data)} bytes")
    fmt_id, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"FTEX format table at offset {where}")
    if where + 4 > len(data):
        raise native.NotOpened(f"FTEX mipmap at {where}, past the file's "
                               f"end")
    size = struct.unpack_from("<i", data, where)[0]
    if size < -1:
        raise ValueError(f"FTEX mipmap of {size} bytes (a read of a "
                         f"negative length other than -1)")
    # -1: Pillow's read of the rest of the file
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt_id not in FORMATS:
        raise ValueError(f"FTEX of format {fmt_id}: Pillow reads 0 (DXT1) "
                         f"and 1 (uncompressed) only")
    fmt = f"{FORMATS[fmt_id]} FTEX"
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    native.check_pixels(fmt, w, h)
    if fmt_id == 1:
        if len(body) < w * h * 3:
            raise ValueError(f"{fmt}: the mipmap of {len(body)} bytes is "
                             f"truncated ({w * h * 3} needed)")
        return np.frombuffer(body, np.uint8, w * h * 3).reshape(h, w, 3)
    rgba = np.empty((-(-h // 4) * 4, -(-w // 4) * 4, 4), np.uint8)
    try:
        native.bcn(body, 1, False, rgba)
    except ValueError as e:
        raise ValueError(f"{fmt}: {e}") from None
    return np.ascontiguousarray(rgba[:h, :w, :3])
