"""SGI textures (.rgb, .rgba, .sgi, .bw) without Pillow, as Pillow 12's
SgiImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

The 512-byte big-endian header: magic 474, compression (0 raw, 1
run-length), bytes a channel (1 or 2), dimension, width, height and
channels. Pillow's table of modes takes grey (1 channel at dimension 1 or
2), RGB and RGBA (3 or 4 channels at dimension 3), 8- or 16-bit; a 16-bit
sample keeps its high byte. Rows run bottom-up. Raw files hold one plane a
channel after the header; run-length files a table of row starts and one
of row lengths (a row and channel each), decoded in the native library
(native.sgi_rle) with the quirks of Pillow's SgiRleDecode.c: a row's
length counts packets, a row that ends early keeps the previous row's
bytes, a last packet that is not the terminator ends the image without an
error. The colormap field is not read, as Pillow does not read it.

What Pillow refuses raises a ValueError that names SGI: another mode
(2 channels, bytes a channel other than 1 or 2, a dimension outside the
table), a compression other than 0 and 1, truncated data and run-length
overruns. A header too short to read, or an empty image, is not an SGI
image to Pillow, which goes on to the next format (native.NotOpened).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

HEADER = 512
# (bytes a channel, dimension, channels) -> Pillow's mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
         (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
         (2, 3, 4): "RGBA"}


def accept(data: bytes) -> bool:
    return len(data) >= 2 and data[:2] == b"\x01\xda"


def open_sgi(data: bytes) -> tuple:
    """SGI bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): L as its band (16-bit ones by their high bytes), RGB and RGBA converted."""
    if not accept(data):
        raise ValueError("not an SGI file (no magic 474)")
    if len(data) < 12:
        raise native.NotOpened(f"SGI header of {len(data)} bytes")
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    fmt = f"{8 * bpc}-bit SGI of {z} channels at dimension {dim}"
    if (bpc, dim, z) not in MODES:
        raise ValueError(f"{fmt}: not a mode Pillow reads (grey, RGB or "
                         f"RGBA at 8 or 16 bits)")
    if not w or not h:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    if comp not in (0, 1):
        raise ValueError(f"{fmt} with compression {comp}: only raw (0) and "
                         f"run-length (1) exist")
    native.check_pixels(fmt, w, h)
    if comp == 1:
        rows = native.sgi_rle(data, w, h, z, bpc)
        px = rows[..., ::bpc]                        # the high bytes
    else:
        page = w * h * bpc
        if HEADER + z * page > len(data):
            raise ValueError(f"{fmt}: the image data is truncated")
        planes = np.frombuffer(data, np.uint8, z * page, HEADER)
        px = planes.reshape(z, h, w, bpc)[..., 0].transpose(1, 2, 0)
    if z == 1:
        return "L", np.ascontiguousarray(px[::-1, :, 0]), None
    return ("RGB" if z == 3 else "RGBA",
            np.ascontiguousarray(px[::-1, :, :3]), None)
