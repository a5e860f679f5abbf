"""PCX and DCX textures without Pillow, as Pillow 12's PcxImagePlugin and
DcxImagePlugin read them and `convert("RGB")` converts them (the JAX
package's loader).

The 128-byte header: the inclusive window (xmin, ymin, xmax, ymax), the
version, bits a pixel, planes and the bytes a plane row, and a 16-colour
palette. The modes Pillow reads:

  1 bit in 1 plane         black and white;
  1 bit in 2 or 4 planes   indices into the header's palette, each row
                           the bit planes one after another;
  8 bits in 1 plane (v5)   grey, or indices into the 769-byte palette at
                           the file's end (marker 12) when that palette is
                           not the grey ramp; a file shorter than 769
                           bytes cannot be read (Pillow seeks back from
                           its end);
  8 bits in 3 planes (v5)  RGB, each row the red, green and blue planes.

The plane row length is Pillow's own, (width x bits + 7) // 8, made even
where the header's differs; the run-length rows decode in the native
library (native.pcx_rle: a run that crosses a row's end, or data that end
early, is an error). For RGB, Pillow's decoder then moves the planes of a
row whose length is not a multiple of the width, and reads them at
multiples of the width, so a padded row of width 1 or 3 keeps its padding
in the green and blue planes; the 1-bit planes are read a plane row apart.
Both are followed, so a padded row decodes as in Pillow.

A DCX file is a table of up to 1,024 page offsets; its first page is a
PCX at that offset (the 8-bit palette is still read from the end of the
whole file).

What Pillow refuses raises a ValueError that names PCX or DCX: another
combination of version, bits and planes, and damaged data. A header too
short to read or an empty window is not a PCX image to Pillow, which goes
on to the next format (native.NotOpened), and so is a DCX without pages.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

DCX_MAGIC = 987654321


def accept(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def accept_dcx(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] == DCX_MAGIC


def _unpack(buf: np.ndarray, mode: str, planes: int, w: int,
            stride: int) -> np.ndarray:
    """Rows [h, row_bytes] as Pillow reads them: [h, w] indices or grey,
    or [h, w, 3] RGB (its planes at multiples of the width, the 1-bit
    planes at multiples of the plane row)."""
    if mode == "RGB":
        return np.stack([buf[:, k * w:(k + 1) * w] for k in range(3)],
                        axis=-1)
    if mode in ("L", "P8"):
        return buf[:, :w]
    step = stride
    idx = np.zeros((buf.shape[0], w), np.uint8)
    for k in range(planes):
        bits = np.unpackbits(buf[:, k * step:(k + 1) * step], axis=1)
        idx |= bits[:, :w] << np.uint8(k)
    return idx


def _decode_page(data: bytes, pos: int, name: str) -> tuple:
    """The PCX image whose header is at data[pos], as Pillow opens it."""
    s = data[pos:pos + 68]
    if not accept(s):
        raise native.NotOpened(f"not a {name} page (no PCX signature)")
    if len(s) < 68:
        raise native.NotOpened(f"{name} header of {len(s)} bytes")
    xmin, ymin, xmax, ymax = struct.unpack_from("<HHHH", s, 4)
    w, h = xmax + 1 - xmin, ymax + 1 - ymin
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"{name} of an empty window ({xmin}, "
                               f"{ymin}, {xmax}, {ymax})")
    version, bits, planes = s[1], s[3], s[65]
    given = struct.unpack_from("<H", s, 66)[0]
    fmt = f"{name} version {version} of {bits} bits in {planes} planes"
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        if len(data) < 769:
            raise ValueError(f"{fmt} in a file of {len(data)} bytes: Pillow "
                             f"reads its palette 769 bytes before the end")
        tail = np.frombuffer(data, np.uint8, 769, len(data) - 769)
        mode = "L"
        if tail[0] == 12:
            palette = tail[1:].reshape(256, 3)
            if (palette == np.arange(256, dtype=np.uint8)[:, None]).all():
                palette = None
            else:
                mode = "P8"
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{fmt}: not a mode Pillow reads (1 bit in 1, 2 "
                         f"or 4 planes, or version 5 at 8 bits in 1 or 3)")
    native.check_pixels(fmt, w, h)
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    row_bytes = planes * stride
    try:
        buf = native.pcx_rle(data, pos + 128, row_bytes, h)
    except ValueError as e:
        raise ValueError(f"{fmt}: {e}") from None
    if mode == "RGB" and row_bytes % w and row_bytes > w:
        # PcxDecode.c: the planes of a padded row moved to multiples of
        # the width (the first stays)
        bands = row_bytes // w
        step = row_bytes // bands
        for i in range(1, bands):
            buf[:, i * w:(i + 1) * w] = buf[:, i * step:i * step + w].copy()
    px = _unpack(buf, mode, planes, w, stride)
    if mode == "1":
        px = px * np.uint8(255)
    if palette is not None:
        full = np.zeros((256, 3), np.uint8)           # past the end: black
        full[:len(palette)] = palette
        return "P", px, full
    return mode, np.ascontiguousarray(px), None


def open_pcx(data: bytes) -> tuple:
    """PCX bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb)."""
    return _decode_page(data, 0, "PCX")


def open_dcx(data: bytes) -> tuple:
    """DCX bytes -> its first page as Pillow opens it (open_pcx)."""
    if not accept_dcx(data):
        raise ValueError("not a DCX file (no DCX magic)")
    offsets = []
    for i in range(1024):
        at = 4 + 4 * i
        if at + 4 > len(data):
            raise native.NotOpened(f"DCX page table cut at entry {i}")
        offset = struct.unpack_from("<I", data, at)[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise native.NotOpened("DCX without pages")
    return _decode_page(data, offsets[0], "DCX")
