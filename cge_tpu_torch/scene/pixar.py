"""PIXAR raster images (.pxr) without Pillow, as Pillow 12's
PixarImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

The magic 0x80 0xE8 0x00 0x00, then a 512-byte header of which Pillow
reads four little-endian words: the height and width at 416 and 418, the
channel and depth codes at 424 and 426. Only channels 14 with depth 2
give a mode, RGB: rows of width x 3 bytes from offset 1024. Any other
pair leaves the plugin without a mode, which Pillow treats as a file its
plugin did not identify, as it does an empty image or a header cut before
428 bytes: native.NotOpened, so Image.open goes on to the next format.
Data cut short raise a ValueError naming PIXAR.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

MAGIC = b"\x80\xe8\x00\x00"
DATA = 1024


def accept(data: bytes) -> bool:
    return data[:4] == MAGIC


def decode_pixar(data: bytes) -> np.ndarray:
    """PIXAR bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not accept(data):
        raise ValueError("not a PIXAR file (no PIXAR magic)")
    if len(data) < 428:
        raise native.NotOpened(f"PIXAR header of {len(data)} bytes")
    h, w = struct.unpack_from("<HH", data, 416)
    channels, depth = struct.unpack_from("<HH", data, 424)
    if (channels, depth) != (14, 2):
        raise native.NotOpened(f"PIXAR of channels {channels} and depth "
                               f"{depth}: Pillow has a mode for 14 and 2 "
                               f"(RGB) only")
    if not w or not h:
        raise native.NotOpened(f"PIXAR of {w}x{h} pixels")
    fmt = "RGB PIXAR"
    native.check_pixels(fmt, w, h)
    rows = native.raw_rows(data, DATA, h, 3 * w, 3 * w, fmt)
    return rows.reshape(h, w, 3)
