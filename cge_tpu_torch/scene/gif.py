"""GIF textures without Pillow: the first frame, as Pillow 12's
GifImagePlugin reads it and `convert("RGB")` converts it (the JAX
package's loader).

The blocks before the first image descriptor are walked as Pillow walks
them (extensions skipped by their sub-blocks, the last graphic control
extension's transparent index kept, stray bytes skipped one by one). The
image's LZW codes decode in the native library (native.gif_lzw): variable
code widths, clear and end codes, rows in order or in the four interlaced
passes. The frame sits at its offset on the logical screen, which grows to
hold it; the pixels outside it hold the transparent index where the
frame has one, else index 0.

Indices map through the frame's colour table (the local one, else the
global one; black past its end); the transparent index keeps its colour.
A table that is the identity grey ramp counts as none, as in Pillow: a
frame with no table reads as grey (the index is the level), and one whose
local table is the ramp reads through the global table where there is one.
A file with no image, a truncated one, a stream that ends (end code,
terminator or end of file) before the frame's last pixel, or a broken LZW
stream raises a ValueError that names the format.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

SIGNATURES = (b"GIF87a", b"GIF89a")


class _Reader:
    """Pillow's reads of the file: `read` returns what is there (short at
    the end), the numbers raise where bytes are missing."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def byte(self, what: str) -> int:
        b = self.read(1)
        if not b:
            raise ValueError(f"GIF file is truncated in its {what}")
        return b[0]

    def sub_block(self) -> bytes | None:
        """Pillow's data(): the next sub-block, or None at a terminator or
        the end."""
        n = self.read(1)
        return self.read(n[0]) if n and n[0] else None


def _table(r: _Reader, flags: int, what: str) -> np.ndarray | None:
    """A colour table of 2 ** ((flags & 7) + 1) entries as [K, 3], or None
    where it is the identity grey ramp (Pillow's _is_palette_needed)."""
    p = r.read(3 << ((flags & 7) + 1))
    if len(p) < 3 << ((flags & 7) + 1):
        raise ValueError(f"GIF file is truncated in its {what} colour table")
    table = np.frombuffer(p, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(table))[:, None]
    return None if (table == ramp).all() else table


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> the first frame as [H, W, 3] uint8 RGB, row 0 = top."""
    if len(data) < 13 or data[:6] not in SIGNATURES:
        raise ValueError("not a GIF file (no GIF87a / GIF89a signature)")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    r = _Reader(data, 13)
    global_table = _table(r, flags, "global") if flags & 0x80 else None
    transparent = None
    while True:
        c = r.read(1)
        if not c or c == b";":
            raise ValueError("GIF file without an image")
        if c == b"!":
            label = r.byte("extension label")
            block = r.sub_block()
            if label == 0xF9 and block is not None:
                if len(block) < 4:
                    raise ValueError("GIF graphic control extension of "
                                     f"{len(block)} bytes")
                if block[0] & 1:
                    transparent = block[3]
            elif label == 0xFE:                       # comment
                while block:
                    block = r.sub_block()
                continue
            elif label == 0xFF and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    r.sub_block()
            while r.sub_block():
                pass
        elif c == b",":
            desc = r.read(9)
            if len(desc) < 9:
                raise ValueError("GIF file is truncated in its image "
                                 "descriptor")
            x0, y0, w, h, iflags = struct.unpack("<HHHHB", desc)
            break
    local = iflags & 0x80
    table = _table(r, iflags, "local") if local else None
    bits = r.byte("LZW code size")
    if not (local and table is not None):
        table = global_table
    if w == 0 or h == 0:
        raise ValueError(f"GIF image of {w}x{h} pixels")
    if bits > 12:
        raise ValueError(f"GIF LZW minimum code size {bits}: at most 12")
    width, height = max(width, x0 + w), max(height, y0 + h)
    native.check_pixels("GIF", width, height)
    fill = 0 if transparent is None else transparent
    canvas = np.full((height, width), fill, np.uint8)
    frame = np.empty((h, w), np.uint8)
    native.gif_lzw(data, r.pos, bits, frame, bool(iflags & 0x40))
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if table is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    full = np.zeros((256, 3), np.uint8)               # past the end: black
    full[:len(table)] = table
    return full[canvas]
