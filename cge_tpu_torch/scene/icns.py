"""ICNS (macOS icon) textures without Pillow, as Pillow 12's
IcnsImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

An ICNS file is "icns", its length, then entries of a type, a length and
data. Pillow lists the entries to the file's length field, picks the
largest size of its table (SIZES, compared as (width, height, scale)) that
has an entry, and reads every entry of that size in the table's order:

  PNG or JPEG 2000  ic07-ic14 and icp4-icp6: a PNG (image_io.decode_png;
                    read from the entry's start to the PNG's own end) or a
                    J2K codestream or JP2 file (jpeg2000.py, on the entry's
                    bytes alone, converted to RGBA); it wins over the rest;
  run-length colour it32, ih32, il32, is32: raw RGB where the entry holds
                    exactly three bytes a pixel, else each channel's runs
                    (native.icns_rle, cge_raster.cpp), it32's after a
                    4-byte zero lead;
  mask              t8mk, h8mk, l8mk, s8mk: one byte a pixel, which
                    convert("RGB") drops but Pillow reads.

The image's size must be one of the file's sizes at some scale, as Pillow's
size setter checks. What Pillow refuses raises a ValueError naming ICNS and
the case; a file whose header or entry list Pillow cannot read is not an
ICNS file to it (native.NotOpened), and the loader goes on to the next
format, as Image.open does.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import jpeg2000, modes

MAGIC = b"icns"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COMPRESSED = "compressed"      # a PNG or JPEG 2000 entry
_RUNS, _RUNS_LEAD, _MASK = "runs", "runs after a zero lead", "mask"
# IcnsFile.SIZES: (width, height, scale) -> its entry types and readers
SIZES = {
    (512, 512, 2): ((b"ic10", _COMPRESSED),),
    (512, 512, 1): ((b"ic09", _COMPRESSED),),
    (256, 256, 2): ((b"ic14", _COMPRESSED),),
    (256, 256, 1): ((b"ic08", _COMPRESSED),),
    (128, 128, 2): ((b"ic13", _COMPRESSED),),
    (128, 128, 1): ((b"ic07", _COMPRESSED), (b"it32", _RUNS_LEAD),
                    (b"t8mk", _MASK)),
    (64, 64, 1): ((b"icp6", _COMPRESSED),),
    (32, 32, 2): ((b"ic12", _COMPRESSED),),
    (48, 48, 1): ((b"ih32", _RUNS), (b"h8mk", _MASK)),
    (32, 32, 1): ((b"icp5", _COMPRESSED), (b"il32", _RUNS),
                  (b"l8mk", _MASK)),
    (16, 16, 2): ((b"ic11", _COMPRESSED),),
    (16, 16, 1): ((b"icp4", _COMPRESSED), (b"is32", _RUNS),
                  (b"s8mk", _MASK)),
}


def accept(data: bytes) -> bool:
    """IcnsImagePlugin's test: the "icns" magic."""
    return data[:4] == MAGIC


def entries(data: bytes) -> dict:
    """IcnsFile's directory: {type: (start, length)} of the entries up to
    the header's length; native.NotOpened where a header is cut short or
    an entry's length is 0."""
    if len(data) < 8:
        raise native.NotOpened("ICNS header cut short")
    _, filesize = struct.unpack_from(">4sI", data)
    out, i = {}, 8
    while i < filesize:
        if i < 0:
            raise ValueError("ICNS entry list seeks before the file's start")
        if i + 8 > len(data):
            raise native.NotOpened(f"ICNS entry header at {i} cut short (the "
                                   f"header's length is {filesize})")
        kind, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise native.NotOpened(f"ICNS entry {kind!r}: invalid block "
                                   f"header")
        out[kind] = (i + 8, size - 8)
        i += size
    return out


def best_size(found: dict) -> tuple:
    """IcnsFile.bestsize: the largest (width, height, scale) of SIZES with
    an entry."""
    sizes = [size for size, kinds in SIZES.items()
             if any(k in found for k, _ in kinds)]
    if not sizes:
        raise native.NotOpened("ICNS without 32-bit icon resources")
    return max(sizes)


def _compressed(data: bytes, start: int, length: int) -> tuple:
    """read_png_or_jpeg2000: (mode, pixels, palette; modes.rgb), a PNG in
    its own mode, a JPEG 2000 converted to RGBA."""
    from cge_tpu_torch.scene import image_io

    sig = data[start:start + 12]
    if sig.startswith(PNG_SIGNATURE):
        return image_io.open_png(data[start:])
    if sig.startswith((jpeg2000.J2K_MAGIC, b"\x0d\x0a\x87\x0a")) or \
            sig == jpeg2000.JP2_MAGIC:
        stream = data[start:start + length]
        try:
            opened = jpeg2000.pillow_header(stream)
        except native.NotOpened as e:
            raise ValueError(f"ICNS JPEG 2000 entry: {e}") from None
        native.check_pixels("ICNS JPEG 2000 entry", *opened[1])
        return "RGBA", jpeg2000.to_rgb(*jpeg2000.decode_jpeg2000(
            stream, opened)), None
    raise ValueError(f"ICNS entry of an unsupported subimage format (its "
                     f"first bytes are {sig[:8]!r})")


def _runs(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """read_32: raw RGB where length is three bytes a pixel, else the
    run-length channels."""
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("ICNS raw RGB entry cut short (not enough image "
                             "data)")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3)
    return native.icns_rle(data, start, n).reshape(side, side, 3)


def decode_icns(data: bytes) -> np.ndarray:
    """ICNS bytes -> the image Pillow loads as [H, W, 3] uint8 RGB, row 0 =
    top."""
    return modes.rgb(*open_icns(data))


def open_icns(data: bytes) -> tuple:
    """ICNS bytes -> the image Pillow loads (mode, pixels, palette;
    modes.rgb): a PNG entry in the PNG's mode, the others RGB or RGBA."""
    if not accept(data):
        raise ValueError("not an ICNS file (no icns magic)")
    found = entries(data)
    size = best_size(found)
    side = size[0] * size[2]
    rgb = compressed = None
    mode = "RGB"
    for kind, reader in SIZES[size]:
        if kind not in found:
            continue
        start, length = found[kind]
        if reader == _COMPRESSED:
            compressed = _compressed(data, start, length)
        elif reader == _MASK:
            mode = "RGBA"                     # Pillow puts it in as alpha
            if start + side * side > len(data):
                raise ValueError(f"ICNS mask {kind!r} cut short (not enough "
                                 f"image data)")
        else:
            if reader == _RUNS_LEAD:
                if data[start:start + 4] != bytes(4):
                    raise ValueError("ICNS it32 entry without its zero lead "
                                     "(unknown signature)")
                start, length = start + 4, length - 4
            rgb = _runs(data, start, length, side)
    if compressed is None:
        if rgb is None:
            raise ValueError(f"ICNS size {size} with a mask but no colour "
                             f"entry")
        return mode, rgb, None
    h, w = compressed[1].shape[:2]
    if not any(_scales_to(s, (w, h)) for s in SIZES if any(
            k in found for k, _ in SIZES[s])):
        raise ValueError(f"ICNS entry of {w}x{h} pixels: not one of the "
                         f"allowed sizes of this image")
    return compressed


def _scales_to(size: tuple, value: tuple) -> bool:
    """IcnsImageFile's size setter: a size of the file whose width is a
    whole multiple of value's by the same factor as its height."""
    width, height = size[0] * size[2], size[1] * size[2]
    if not value[0] or not value[1]:
        raise ValueError("ICNS entry of an empty image")
    return height / value[1] == width // value[0]
