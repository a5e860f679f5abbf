"""ICO and CUR textures without Pillow, as Pillow 12's IcoImagePlugin and
CurImagePlugin read them and `convert("RGB")` converts them (the JAX
package's loader).

Both files are a 6-byte header and a directory of 16-byte entries (width
and height bytes, 0 meaning 256 in an icon, colour count, planes, bits a
pixel, size and offset of the entry's data). The entry Pillow opens:

  ICO  the directory sorted by colour depth (the bits a pixel, else
       ceil(log2) of the colour count, else 256), then, stably, by area
       from the largest: the first, so the largest image at its smallest
       depth. Its data is a PNG (image_io.decode_png) or a device-
       independent bitmap (image_io.decode_dib) whose height counts the AND
       mask's rows too, so is halved; Pillow reads the AND mask (or, for a
       32-bit entry, the alpha bytes) before the image and refuses the file
       where they are cut short, though convert("RGB") drops them again.
  CUR  the first entry unless a later one is larger in both the width and
       the height byte (a 0 byte loses that comparison); its data a bitmap
       of halved height, as in an icon, without the mask.

What Pillow refuses raises a ValueError that names ICO or CUR, with the
bitmap's or PNG's own reason. An icon or cursor without entries, a
directory cut short and an empty image are not ICO or CUR images to
Pillow, which goes on to the next format (native.NotOpened).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

ICO_MAGIC = b"\x00\x00\x01\x00"
CUR_MAGIC = b"\x00\x00\x02\x00"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def accept_ico(data: bytes) -> bool:
    return data[:4] == ICO_MAGIC


def accept_cur(data: bytes) -> bool:
    return data[:4] == CUR_MAGIC


def _entries(data: bytes, name: str) -> list:
    """The directory's entries, each its 16 bytes; NotOpened where the
    header or an entry is cut short."""
    if len(data) < 6:
        raise native.NotOpened(f"{name} header of {len(data)} bytes")
    count = struct.unpack_from("<H", data, 4)[0]
    return [data[6 + 16 * i:22 + 16 * i] for i in range(count)]


def _icon_entry(data: bytes) -> tuple:
    """The (offset, size, bits a pixel) of the entry Pillow's IcoFile
    opens."""
    keys = []
    for s in _entries(data, "ICO"):
        if len(s) < 16:
            raise native.NotOpened("ICO directory is cut short")
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        keys.append((w * h, depth, offset, size, bpp))
    if not keys:
        raise native.NotOpened("ICO without entries")
    keys.sort(key=lambda k: k[1])
    keys.sort(key=lambda k: k[0], reverse=True)
    return keys[0][2:]


def open_ico(data: bytes) -> tuple:
    """ICO bytes -> the entry as Pillow opens it (mode, pixels, palette;
    modes.rgb): a PNG entry in the PNG's mode, a bitmap as RGBA (Pillow
    puts the AND mask or the alpha bytes in as alpha)."""
    from cge_tpu_torch.scene import image_io

    if not accept_ico(data):
        raise ValueError("not an ICO file (no ICO signature)")
    offset, size, bpp = _icon_entry(data)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return image_io.open_png(data[offset:])
    rgb = image_io.decode_dib(data, offset, halve="ICO")
    h, w = rgb.shape[:2]
    if bpp == 32:
        # the alpha bytes: every fourth byte of the 32-bit pixel rows
        end = _pixels_at(data, offset) + 4 * w * h
        what = "32-bit entry's alpha bytes"
    else:
        stride = -(-w // 32) * 4
        start = offset + size - stride * h
        # the raw decoder needs the last row's bits, not its padding
        end = start + stride * (h - 1) + (w + 7) // 8
        what = f"AND mask ({stride * h} bytes at {start})"
        if start < 0:
            raise ValueError(f"ICO {what} starts before the file")
    if end > len(data):
        raise ValueError(f"ICO {what} is truncated")
    return "RGBA", rgb, None


def _pixels_at(data: bytes, pos: int) -> int:
    """Where the pixels of the bitmap whose header is at pos start (after
    its header, masks and palette), as Pillow's _bitmap finds them."""
    hsize = struct.unpack_from("<I", data, pos)[0]
    if hsize == 12:
        bits = struct.unpack_from("<H", data, pos + 10)[0]
        return pos + 12 + (3 << bits if bits <= 8 else 0)
    bits, comp = struct.unpack_from("<HI", data, pos + 14)
    colors = struct.unpack_from("<I", data, pos + 32)[0] or 1 << bits
    if bits <= 8:
        return pos + hsize + 4 * colors
    return pos + hsize + (12 if comp == 3 and hsize < 52 else 0)


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes -> the entry Pillow opens as [H, W, 3] uint8 RGB, row 0 =
    top."""
    return modes.rgb(*open_cur(data))


def open_cur(data: bytes) -> tuple:
    """CUR bytes -> the entry's bitmap as Pillow opens it (in the bitmap's
    mode: image_io.open_dib)."""
    from cge_tpu_torch.scene import image_io

    if not accept_cur(data):
        raise ValueError("not a CUR file (no CUR signature)")
    entries = _entries(data, "CUR")
    m = b""
    try:
        for s in entries:
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
    except IndexError:
        raise native.NotOpened("CUR directory is cut short") from None
    if not m:
        raise native.NotOpened("CUR without entries")
    if len(m) < 16:
        raise native.NotOpened("CUR directory is cut short")
    at = struct.unpack_from("<I", m, 12)[0]
    if not at:            # no seek: the bitmap is read where the file is
        at = min(len(data), 6 + 16 * len(entries))
    return image_io.open_dib(data, at, halve="CUR")
