"""Sun raster textures (.ras) without Pillow, as Pillow 12's SunImagePlugin
reads them and `convert("RGB")` converts them (the JAX package's loader).

The 32-byte big-endian header: magic 0x59A66A95, width, height, depth, a
data length that is not read, the file type, the colour map's type and
length. Depth 1 is black and white with 1 for black, 4 and 8 grey (4-bit
levels x 17), or indices into the colour map where the file has one (an RGB
map, all reds, then all greens, then all blues; indices past its end are
black), 24 and 32 BGR or BGRX, or RGB and RGBX in file type 3. File types
0, 1, 3, 4 and 5 hold raw rows padded to 16 bits (the last row's padding
may be missing, as Pillow's raw decoder skips it); type 2 run-length data
(native.sun_rle, Pillow's SunRleDecode.c), whose rows Pillow takes
unpadded and whose runs flow on across rows.

What Pillow refuses raises a ValueError that names Sun raster: a colour
map beside a depth of 1, 24 or 32 or of more than 256 colours, and
truncated data. Another depth, file type or colour-map type, a map of more
than 1,024 bytes, a header too short to read and an empty image are not a
Sun raster to Pillow, which goes on to the next format (native.NotOpened).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

MAGIC = 0x59A66A95
HEADER = 32
# the depths Pillow reads
DEPTHS = (1, 4, 8, 24, 32)


def accept(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from(">I", data)[0] == MAGIC


def open_sun(data: bytes) -> tuple:
    """Sun raster bytes -> the image as Pillow opens it (mode, pixels,
    palette; modes.rgb): 1, L, P with a colour map, RGB."""
    if not accept(data):
        raise ValueError("not a Sun raster file (no Sun raster magic)")
    if len(data) < HEADER:
        raise native.NotOpened(f"Sun raster header of {len(data)} bytes")
    _, w, h, depth, _, ftype, maptype, maplen = struct.unpack_from(
        ">8I", data)
    fmt = f"{depth}-bit Sun raster of file type {ftype}"
    if depth not in DEPTHS:
        raise native.NotOpened(f"{fmt}: Pillow reads depths {DEPTHS} only")
    if maplen and maplen > 1024:
        raise native.NotOpened(f"{fmt} with a {maplen}-byte colour map")
    if maplen and maptype != 1:
        raise native.NotOpened(f"{fmt} with colour map type {maptype}")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise native.NotOpened(f"{fmt}: not a file type Pillow reads")
    if not w or not h:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    palette = None
    if maplen:
        if depth not in (4, 8):
            raise ValueError(f"{fmt} with a colour map, which Pillow cannot "
                             f"convert")
        n = maplen // 3
        if n > 256:
            raise ValueError(f"{fmt} with a colour map of {n} colours, past "
                             f"Pillow's 256")
        if HEADER + maplen > len(data):
            raise ValueError(f"{fmt}: the colour map is truncated")
        planes = np.frombuffer(data, np.uint8, 3 * n, HEADER).reshape(3, n)
        palette = np.zeros((256, 3), np.uint8)          # past the end: black
        palette[:n] = planes.T
    native.check_pixels(fmt, w, h)
    pos = HEADER + maplen
    if ftype == 2:
        row_bytes = (w * depth + 7) // 8
        rows = native.sun_rle(data, pos, row_bytes, h)
    else:
        rows = native.raw_rows(data, pos, h, (w * depth + 15) // 16 * 2,
                               (w * depth + 7) // 8, fmt)
    if depth == 1:
        px = (1 - np.unpackbits(rows, axis=1)[:, :w]) * np.uint8(255)
    elif depth == 4:
        px = np.stack([rows >> 4, rows & 15], axis=2).reshape(h, -1)[:, :w]
        if palette is None:
            px = px * np.uint8(17)
    elif depth == 8:
        px = rows[:, :w]
    else:
        ch = depth // 8
        px = rows[:, :w * ch].reshape(h, w, ch)[..., :3]
        return "RGB", np.ascontiguousarray(
            px if ftype == 3 else px[..., ::-1]), None
    mode = "1" if depth == 1 else "L" if palette is None else "P"
    return mode, np.ascontiguousarray(px), palette
