"""FITS images (.fit, .fits) without Pillow, as Pillow 12's FitsImagePlugin
reads them and `convert("RGB")` converts them (the JAX package's loader).

The header is read as 80-byte cards, each keyword its first 8 bytes
stripped, each value what follows up to a '/', stripped, a leading '='
dropped; the first card must be SIMPLE = T. At END the reader moves to the
next 2880-byte block and reads the cards gathered so far (one dictionary
over every header unit): NAXIS 0 goes on to the next unit (XTENSION), NAXIS
1 is an image of 1 x NAXIS1, else NAXIS1 x NAXIS2, and BITPIX 8, 16, 32,
-32 or -64 gives the mode L, I;16, I or F. The data start at the first card
after the header that is no SIMPLE or XTENSION card, found as Pillow finds
it: 80 bytes back from where that card's read ended.

The samples are read as Pillow reads them: in the mode's own raw layout,
little-endian (so FITS's big-endian samples come out byte-swapped: 300 at
BITPIX 16 reads as 11265), BITPIX -64 as float32 pairs, BZERO and BSCALE
ignored, rows from the bottom. A BINTABLE extension of ZIMAGE T and
ZCMPTYPE 'GZIP_1  ' holds its image as Pillow's FitsGzipDecoder reads it:
the stream after the table's NAXIS1 x NAXIS2 x BITPIX / 8 bytes gunzipped,
of every 4 bytes the last ZBITPIX / 8, rows from the bottom. Then L is
grey, I;16 and I saturate at 0 and 255, F is clamped and truncated, a NaN
refused (modes.py).

A first card that is not SIMPLE = T, a missing NAXIS or BITPIX card, a
BITPIX of no mode and an empty image are Pillow's SyntaxError (KeyError
included): native.NotOpened. What escapes Image.open raises a ValueError
naming FITS: a file that ends in its header, a header of no image ("No
image data"), a value int() refuses, data cut short, a stream gzip
refuses.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

CARD = 80
BLOCK = 2880
# BITPIX -> Pillow's mode, and how its raw decoder reads the samples
MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"),
         -32: ("F", "<f4"), -64: ("F", "<f4")}


def accept(data: bytes) -> bool:
    return data[:6] == b"SIMPLE"


def _size(headers: dict, prefix: bytes):
    """FitsImageFile._get_size: (width, height), or None for NAXIS 0."""
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict, image: dict) -> tuple:
    """FitsImageFile._parse_headers: (decoder, offset), the decoder ""
    where the unit holds no image; sets image's size and mode."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0
    image["size"] = size
    bits = int(headers[prefix + b"BITPIX"])
    if bits in MODES:
        image["mode"] = MODES[bits][0]
    image["bits"] = bits
    return decoder, offset


def header(data: bytes) -> dict:
    """FitsImageFile._open over data: {"size", "mode", "bits", "decoder",
    "offset"}; native.NotOpened where Pillow's plugin does not open the
    file, ValueError where _open raises what escapes Image.open."""
    headers, image = {}, {"mode": ""}
    in_progress, decoder, pos = False, "", 0
    while True:
        card = data[pos:pos + CARD]
        pos += len(card)
        if not card:
            raise ValueError("Truncated FITS file (it ends in its header)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                                   # the data unit
        elif keyword == b"END":
            pos = -(-pos // BLOCK) * BLOCK
            if not decoder:
                decoder, offset = _parse(headers, image)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise native.NotOpened("Not a FITS file (its first card is not "
                                   "SIMPLE = T)")
        headers[keyword] = value
    if not decoder:
        raise ValueError("FITS file of no image data (No image data)")
    image.update(decoder=decoder, offset=offset + pos - CARD)
    return image


def _open(data: bytes) -> dict:
    """header, its KeyError mapped as Image.open maps it (int()'s
    refusals escape), and the mode and size checks."""
    try:
        image = header(data)
    except KeyError as e:
        raise native.NotOpened(f"FITS header without the card {e}") from None
    w, h = image.get("size", (0, 0))
    if not image["mode"] or w <= 0 or h <= 0:
        raise native.NotOpened(f"FITS of BITPIX {image.get('bits')} and "
                               f"{w}x{h} pixels: no mode or an empty image")
    return image


def open_fits(data: bytes) -> tuple:
    """FITS bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb): L and I;16 as their band, I and F converted."""
    if not accept(data):
        raise ValueError("not a FITS file (no SIMPLE card)")
    image = _open(data)
    (w, h), mode, offset = image["size"], image["mode"], image["offset"]
    gz = image["decoder"] == "fits_gzip"
    fmt = f"{mode} FITS" + (" (GZIP_1)" if gz else "")
    native.check_pixels(fmt, w, h)
    if offset < 0:
        raise ValueError(f"{fmt}: its data offset {offset} is negative")
    dt = np.dtype(MODES[image["bits"]][1])
    rb = w * dt.itemsize
    if gz:
        try:
            value = gzip.decompress(data[offset:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"{fmt}: the stream does not gunzip ({e})") \
                from None
        keep = min(image["bits"] // 8, 4)
        if keep <= 0 or len(value) < 4 * w * h:
            raise ValueError(f"{fmt}: {len(value)} bytes gunzipped for "
                             f"{w * h} samples (not enough image data)")
        quads = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
        rows = np.ascontiguousarray(quads[::-1, :, 4 - keep:]).reshape(h, rb)
        px = rows.view(dt).reshape(h, w)
    else:
        rows = native.raw_rows(data, offset, h, rb, rb, fmt)
        px = rows.view(dt).reshape(h, w)[::-1]
    if mode == "F":
        return mode, modes.grey(modes.f_to_u8(px, fmt)), None
    if mode == "I":
        return mode, modes.grey(modes.i_to_u8(px)), None
    return mode, px, None
