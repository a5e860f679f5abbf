"""McIdas area files without Pillow, as Pillow 12's McIdasImagePlugin
reads them and `convert("RGB")` converts them (the JAX package's loader).

The file starts with seven bytes 0 and a 4, the first of a 256-byte
directory of 64 big-endian words, w[1] to w[64] as Pillow numbers them:
w[11] bytes an element gives the mode (1: L, 2: I;16B, 4: I from
big-endian 32-bit words; any other is not opened), the image is w[10]
elements by w[9] lines, its first line's elements at w[34] + w[15], each
line w[15] + w[10] x w[11] x w[14] bytes after the last (a prefix of w[15]
bytes and w[14] bands, of which the first is read).

Pillow reads L and I;16B by mapping the file where it holds offset +
lines x stride bytes: lines then overlap where the stride is shorter than
a line (the last line may so reach past the file's end, into the zeros
that fill the map's last page), and follow one another where it is 0 or
less (a stride past a C int is an OverflowError there); where the file is
shorter its
raw decoder reads the lines, refusing a stride shorter than a line, and
needing only the last line's elements. I is read by the raw decoder.
Then L is grey, I;16B and I saturate at 0 and 255 (modes.py).

A directory cut short, an element size of no mode and an empty image are
not McIdas files to Pillow (native.NotOpened); a negative data offset, a
stride the decoder refuses and data cut short raise a ValueError naming
McIdas.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

MAGIC = b"\x00" * 7 + b"\x04"
DIRECTORY = 256
PAGE = 4096                  # the file's map ends at a page, zero-filled
# w[11] -> Pillow's mode and the samples' numpy type
MODES = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def accept(data: bytes) -> bool:
    return data[:8] == MAGIC


def _lines(data: bytes, offset: int, h: int, rb: int, stride: int,
           mapped: bool, fmt: str) -> np.ndarray:
    """The lines [h, rb] uint8 as Pillow's loader reads them: mapped (L
    and I;16B) where the file holds offset + h x stride bytes, else by the
    raw decoder."""
    if offset < 0:
        raise ValueError(f"{fmt}: its data offset {offset} is negative")
    if mapped and offset + h * stride <= len(data):
        if not -2 ** 31 <= stride < 2 ** 31:
            raise ValueError(f"{fmt}: a line stride of {stride} bytes, past "
                             f"the C int of Pillow's map_buffer")
        step = stride if stride > 0 else rb
        if offset + h * step > len(data):
            raise ValueError(f"{fmt}: the file holds {len(data)} bytes, not "
                             f"the {offset + h * step} its lines need")
        end = offset + step * (h - 1) + rb
        page = -(-len(data) // PAGE) * PAGE
        if end > page:
            raise ValueError(f"{fmt}: its last line ends {end - len(data)} "
                             f"bytes past the file, past the page Pillow "
                             f"maps, where its read faults")
        at = offset + step * np.arange(h)[:, None] + np.arange(rb)
        mapped = np.zeros(max(end, len(data)), np.uint8)
        mapped[:len(data)] = np.frombuffer(data, np.uint8)
        return mapped[at]
    if stride and stride < rb:
        raise ValueError(f"{fmt}: a line stride of {stride} bytes, shorter "
                         f"than its {rb} bytes of elements")
    step = stride or rb
    return native.raw_rows(data, offset, h, step, rb, fmt)[:, :rb]


def open_mcidas(data: bytes, from_file: bool = True) -> tuple:
    """McIdas bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): L and I;16B as their band, I converted. from_file False:
    bytes Pillow opens from memory, which it never maps (the raw decoder
    reads every mode)."""
    if not accept(data):
        raise ValueError("not an McIdas area file (no 00 x 7, 04 prefix)")
    if len(data) < DIRECTORY:
        raise native.NotOpened(f"McIdas directory of {len(data)} bytes")
    w = (0,) + struct.unpack_from("!64i", data)
    if w[11] not in MODES:
        raise native.NotOpened(f"McIdas of {w[11]} bytes an element "
                               f"(unsupported McIdas format)")
    mode, dt = MODES[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise native.NotOpened(f"McIdas of {width}x{height} pixels")
    fmt = f"{mode} McIdas"
    native.check_pixels(fmt, width, height)
    rb = width * w[11]
    lines = _lines(data, w[34] + w[15], height, rb,
                   w[15] + w[10] * w[11] * w[14], from_file and mode != "I",
                   fmt)
    px = np.ascontiguousarray(lines).view(dt).reshape(height, width)
    if mode == "I":
        return mode, modes.grey(modes.i_to_u8(px)), None
    return mode, px, None
