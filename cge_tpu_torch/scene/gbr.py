"""GIMP brushes (.gbr) without Pillow, as Pillow 12's GbrImagePlugin reads
them and `convert("RGB")` converts them (the JAX package's loader).

The big-endian header: its size, the version (1 or 2), width, height and
depth (1 for grey, 4 for RGBA), and in version 2 the magic "GIMP" and the
spacing. A comment of the header's size less 20 (version 1) or 28
(version 2) bytes follows; a version 2 header of 20 to 27 bytes makes
that length negative, and Pillow's read of it takes the rest of the file.
Then width x height x depth bytes: grey repeated into RGB, or RGBA
without its alpha.

Pillow's test of the first bytes takes any header size of at least 20 and
version 1 or 2; its plugin then refuses a width or height of 0, another
depth, version 2 without the magic, and a header cut short. `accept` is
the test and those checks together, so that `format_of` names the format
that opens the file; `open_gbr` raises native.NotOpened for them, as
Pillow's plugin does (Image.open then tries the next format). Data cut
short is Pillow's "not enough image data", a ValueError naming GBR.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native


def _header(data: bytes):
    """(header size, version, width, height, depth), or the reason
    Pillow's plugin cannot open the file."""
    if len(data) < 20:
        return f"GBR header of {len(data)} bytes"
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20:
        return f"GBR header size {size}"
    if version not in (1, 2):
        return f"GBR version {version}"
    if not w or not h:
        return f"GBR of {w}x{h} pixels"
    if depth not in (1, 4):
        return f"GBR of depth {depth}: Pillow reads 1 (grey) and 4 (RGBA)"
    if version == 2 and data[20:24] != b"GIMP":
        return "GBR version 2 without its GIMP magic"
    if version == 2 and len(data) < 28:
        return "GBR version 2 header cut before its spacing"
    return size, version, w, h, depth


def accept(data: bytes) -> bool:
    """Pillow's test of the first bytes and its plugin's header checks."""
    return not isinstance(_header(data), str)


def open_gbr(data: bytes) -> tuple:
    """GBR bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): L as its band, or RGBA converted."""
    head = _header(data)
    if isinstance(head, str):
        raise native.NotOpened(head)
    size, version, w, h, depth = head
    fmt = f"{'grey' if depth == 1 else 'RGBA'} GBR version {version}"
    native.check_pixels(fmt, w, h)
    fixed = 20 if version == 1 else 28
    comment = size - fixed
    start = fixed + comment if comment >= 0 else len(data)
    need = w * h * depth
    body = data[start:start + need]
    if len(body) < need:
        raise ValueError(f"{fmt}: not enough image data ({len(body)} of "
                         f"{need} bytes)")
    px = np.frombuffer(body, np.uint8).reshape(h, w, depth)
    if depth == 1:
        return "L", px[..., 0], None
    return "RGBA", np.ascontiguousarray(px[..., :3]), None
