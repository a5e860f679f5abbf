"""Autodesk FLI / FLC animations without Pillow: the first frame, as Pillow
12's FliImagePlugin reads it and `convert("RGB")` converts it (the JAX
package's loader).

The 128-byte little-endian header: the magic 0xAF11 (FLI) or 0xAF12 (FLC)
at 4, the width and height at 8 and 10, flags 0 or 3 at 14, and bytes
20-21, 42-79 and 88-127 zero; anything else is not an FLI file to Pillow.
The palette, grey where none is found, is read as Pillow's _open reads it:
the chunk at 128 (or, past a 0xF100 prefix chunk, the one after it), if it
is a frame chunk (0xF1FA), is searched sub-chunk by sub-chunk for the
first COLOR_256 (4) or COLOR_64 (11, its values shifted left by 2 and
kept to 8 bits) chunk, whose packets skip entries and set runs of them
(a count of 0 sets 256). A palette index past 255, a read past the file's
end, a frame count of 0 and a frame size the file does not hold make
Pillow's plugin fail to open the file (native.NotOpened: Image.open goes
on to the next format).

The first frame is then decoded from offset 128, whatever the prefix
chunk: Pillow's tile starts there, so a file with a prefix chunk fails (its
decoder finds no frame chunk). Pillow's loader reads the frame in blocks
of its size until the decoder has the whole frame (one pad byte may be
missing) and hands it the bytes read so far; the frame's sub-chunks are
walked in the native library (native.fli_frame, cge_raster.cpp, as
FliDecode.c). What fails there, and a frame the file cuts short, raise a
ValueError naming FLI.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

HEADER = 128
MAGICS = (0xAF11, 0xAF12)
FRAME = 0xF1FA
PREFIX = 0xF100


def accept(data: bytes) -> bool:
    """FliImagePlugin._accept: the magic and the flags."""
    return (len(data) >= 16 and struct.unpack_from("<H", data, 4)[0]
            in MAGICS and struct.unpack_from("<H", data, 14)[0] in (0, 3))


def _u16(data: bytes, at: int) -> int:
    """i16 of Pillow's _binary: struct.error (NotOpened) past the end."""
    if at + 2 > len(data):
        raise native.NotOpened("FLI header cut short (a read past the "
                               "file's end)")
    return struct.unpack_from("<H", data, at)[0]


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise native.NotOpened("FLI header cut short (a read past the "
                               "file's end)")
    return struct.unpack_from("<I", data, at)[0]


def palette(data: bytes) -> np.ndarray:
    """FliImageFile._open's palette search: [256, 3] uint8."""
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = HEADER
    if _u16(data[pos:pos + 16], 4) == PREFIX:
        pos = HEADER + _u32(data, pos)
    head = data[pos:pos + 16]
    pos += 16
    if _u16(head, 4) != FRAME:
        return pal
    size = None
    for _ in range(_u16(head, 6)):
        if size is not None:
            pos += size - 6
        sub = data[pos:pos + 6]
        pos += 6
        kind = _u16(sub, 4)
        if kind in (4, 11):
            shift = 2 if kind == 11 else 0
            i = 0
            packets = _u16(data[pos:pos + 2], 0)
            pos += 2
            for _ in range(packets):
                s = data[pos:pos + 2]
                pos += 2
                if len(s) < 2:
                    raise native.NotOpened("FLI palette chunk cut short")
                i += s[0]
                n = s[1] or 256
                rgb = data[pos:pos + 3 * n]
                pos += 3 * n
                if len(rgb) % 3:
                    raise native.NotOpened("FLI palette chunk cut short")
                k = len(rgb) // 3
                if k and i + k > 256:
                    raise native.NotOpened(f"FLI palette sets entry "
                                           f"{max(i, 256)}, past 255")
                vals = np.frombuffer(rgb, np.uint8).reshape(k, 3)
                pal[i:i + k] = vals << np.uint8(shift)
                i += k
            return pal
        size = _u32(sub, 0)
        if not size:
            break
    return pal


def _frame_bytes(data: bytes, fmt: str) -> bytes:
    """The bytes ImageFile.load hands FliDecode when it decodes: read in
    blocks of the frame's size from offset 128 until the decoder asks for
    no more (4 bytes, and the frame's size less a missing pad byte)."""
    size = _u32(data, HEADER)
    got, pos = 0, HEADER
    while got < 4 or got + got % 2 < size:
        step = min(size, len(data) - pos)
        if step <= 0:
            raise ValueError(f"{fmt}: image file is truncated (the frame of "
                             f"{size} bytes holds {got})")
        got += step
        pos += step
    return data[HEADER:HEADER + got]


def decode_fli(data: bytes) -> np.ndarray:
    """FLI / FLC bytes -> [H, W, 3] uint8 RGB of the first frame, row 0 =
    top."""
    if not accept(data):
        raise ValueError("not an FLI file (no FLI magic and flags)")
    head = data[:HEADER]
    if not (head[20:22] == b"\0\0" and head[42:80] == bytes(38)
            and head[88:] == bytes(40)):
        raise native.NotOpened("FLI header whose reserved bytes are not 0")
    magic, frames, w, h = struct.unpack_from("<4H", data, 4)
    pal = palette(data)
    if not frames:
        raise native.NotOpened("FLI of 0 frames (Pillow's seek to the first "
                               "fails)")
    _u32(data, HEADER)                  # _seek's frame size: missing frame
    if not w or not h:
        raise native.NotOpened(f"FLI of {w}x{h} pixels")
    fmt = "FLI" if magic == 0xAF11 else "FLI (FLC)"
    native.check_pixels(fmt, w, h)
    im = np.zeros((h, w), np.uint8)
    try:
        native.fli_frame(_frame_bytes(data, fmt), im)
    except ValueError as e:
        if fmt in str(e):
            raise
        raise ValueError(f"{fmt}: {e}") from None
    return pal[im]
