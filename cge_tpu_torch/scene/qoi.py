"""QOI textures without Pillow, as Pillow 12's QoiImagePlugin reads them
and `convert("RGB")` converts them (the JAX package's loader).

The 14-byte header: "qoif", big-endian width and height, channels (3 is
RGB, any other value RGBA) and the colour space, which is not read. The op
stream decodes in the native library (native.qoi) as Pillow's QoiDecoder
does it; alpha is dropped. The stream's end marker is not read. A stream
that ends before the last pixel raises a ValueError that names QOI, as
Pillow refuses it; a header cut before its channels byte, or an empty
image, is not a QOI image to Pillow, which goes on to the next format
(native.NotOpened).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

MAGIC = b"qoif"


def accept(data: bytes) -> bool:
    return data[:4] == MAGIC


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not accept(data):
        raise ValueError("not a QOI file (no qoif signature)")
    if len(data) < 13:
        raise native.NotOpened(f"QOI header of {len(data)} bytes")
    w, h = struct.unpack_from(">II", data, 4)
    fmt = f"{'RGB' if data[12] == 3 else 'RGBA'} QOI"
    if not w or not h:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    native.check_pixels(fmt, w, h)
    try:
        rgba = native.qoi(data, 14, w * h)
    except ValueError as e:
        raise ValueError(f"{fmt} of {w}x{h} pixels: {e}") from None
    return np.ascontiguousarray(rgba[:, :3].reshape(h, w, 3))
