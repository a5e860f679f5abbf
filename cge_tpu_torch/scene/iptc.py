"""IPTC/NAA image streams (.iim) without Pillow, as Pillow 12's
IptcImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

IPTC has no signature: Image.open tries the plugin on every file that
reaches it (after IM Tools, before McIdas). The stream is a run of
fields, each 0x1C, a record (1 to 9 or 240) and a tag, then a size: 2
bytes, or 0x80 for none, or 0x81 to 0x84 for a size of that many bytes
after it (over 0x84 is Pillow's OSError); five NUL bytes or the end stop
the run, as does the first (8,10) field. Then (3,60) gives the mode (1
layer of component 0: L; 3 or 4 layers of a component other than 0: RGB
or CMYK, with the band (3,65) - 1, or 0), (3,20) and (3,30) the width and
height, (3,120) the compression: 1 raw, 5 JPEG, anything else an OSError.

The image is the data of the (8,10) fields that follow one another from
the first, opened as Pillow opens it, by Image.open of those bytes (a P5
header of the declared size before raw data): here image_io.open_image,
the whole dispatch, which gives Pillow's mode and, for a mode of one band,
the band as Pillow's image holds it. An L image is that image as it
decodes (its own size and mode), but one of F, I;16L, I;16B or LAB, which
Pillow converts to RGB through their base mode L, which the IPTC image's
mode L hides (so Pillow refuses it); an RGB or CMYK one puts that band in the
band's place of an otherwise black image of its size, a band of -1 the
last, as Python indexes Image.merge's list (band 2 of RGB is green only),
CMYK then through cmyk2rgb. Image.merge holds every band but the first to
mode L; the first may be any image of one band, whose rows ImagingMerge
reads a byte a pixel: the pixels of 1 (0 or 255), L and P (its indices),
and of the I;16 modes the first width bytes of each row as stored (pixel
x takes byte x of the little-endian or big-endian row).

A field of a record not in the list, a header cut short, no (3,60),
(3,20) or (3,30) field (KeyError is Pillow's SyntaxError here), no mode
and an empty image are not IPTC streams to Pillow (native.NotOpened).
What escapes Image.open raises a ValueError naming IPTC: a field size
over 0x84, a compression other than 1 and 5 (and none), no (8,10) field,
a field after the image data that is not one, a band past the mode's, a
nested image that does not decode, a band after the first whose image is
not L ("mode mismatch"), a first band of several ("image has wrong
mode"). A first band of mode I or F, whose rows ImagingMerge reads through
a pointer Pillow never sets for four-byte pixels, ends JAX's process
(Pillow segfaults): the port refuses it, naming why.
"""

from __future__ import annotations

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
# the modes Pillow's core converts to RGB only through another mode
_NO_RGB = ("F", "I;16L", "I;16B", "LAB")
COMPRESSION = {1: "raw", 5: "jpeg"}


def _i(c: bytes) -> int:
    """IptcImagePlugin._i: up to the last 4 bytes, big-endian, unsigned."""
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def field(data: bytes, pos: int) -> tuple:
    """IptcImageFile.field at pos: (tag or None, size, the position after
    the header); native.NotOpened for Pillow's SyntaxError, IndexError and
    struct.error, ValueError for its OSError."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 3:
        raise native.NotOpened("IPTC field header cut short")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in RECORDS:
        raise native.NotOpened("invalid IPTC/NAA file")
    if len(s) < 4:
        raise native.NotOpened("IPTC field header cut short")
    size = s[3]
    if size > 132:
        raise ValueError(f"IPTC field {tag} of size byte {size} (illegal "
                         f"field length in IPTC/NAA file)")
    if size == 128:
        size = 0
    elif size > 128:
        c = data[pos:pos + size - 128]
        pos += len(c)
        size = _i(c)
    else:
        if len(s) < 5:
            raise native.NotOpened("IPTC field header cut short")
        size = int.from_bytes(s[3:5], "big")
    return tag, size, pos


def header(data: bytes) -> dict:
    """IptcImageFile._open and the checks after it: {"mode", "size",
    "band", "compression", "offset" (of the first (8,10) field, or None)}."""
    info, pos = {}, 0
    while True:
        offset = pos
        tag, size, pos = field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = None
        if size:
            value = data[pos:pos + size]
            pos += len(value)
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(value)
            else:
                info[tag] = [info[tag], value]
        else:
            info[tag] = value
    try:
        kind = info[(3, 60)]
        layers, component = kind[0], kind[1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        size = _i(info[(3, 20)]), _i(info[(3, 30)])
    except (KeyError, IndexError, TypeError) as e:
        raise native.NotOpened(f"IPTC header without a usable field "
                               f"({type(e).__name__}: {e})") from None
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except KeyError:
        raise ValueError("IPTC image of no compression 1 or 5 (Unknown IPTC "
                         "image compression)") from None
    except TypeError as e:
        raise native.NotOpened(f"IPTC compression field: {e}") from None
    if not mode or not size[0] or not size[1]:
        raise native.NotOpened(f"IPTC of mode {mode!r} and size {size}")
    native.check_pixels(f"{mode} IPTC", *size)
    return dict(mode=mode, size=size, band=band, compression=compression,
                offset=offset if tag == (8, 10) else None)


def open_iptc(data: bytes, open_nested) -> tuple:
    """IPTC bytes -> the image as Pillow loads it (mode, pixels, palette;
    modes.rgb), row 0 = top; open_nested: the whole dispatch
    (image_io.open_image) for the nested image."""
    head = header(data)
    mode, (w, h), band = head["mode"], head["size"], head["band"]
    fmt = f"{mode} IPTC ({head['compression']})"
    if head["offset"] is None:
        raise ValueError(f"{fmt}: no (8,10) image data field (cannot load "
                         f"this image)")
    parts, pos = [], head["offset"]
    while True:
        try:
            tag, size, pos = field(data, pos)
        except ValueError as e:                 # NotOpened too: at load,
            raise ValueError(f"{fmt}: after the image data: {e}") from None
        if tag != (8, 10):
            break
        part = data[pos:pos + size]
        pos += len(part)
        parts.append(part)
    nested = b"".join(parts)
    if head["compression"] == "raw":
        nested = b"P5\n%d %d\n255\n" % (w, h) + nested
    try:
        inner, px, palette = open_nested(nested)
    except ValueError as e:
        raise ValueError(f"{fmt}: its image data: {e}") from None
    if band is None:
        if inner in _NO_RGB:
            # the image is L to Pillow, so convert("RGB") finds no base
            # mode to convert the nested image through
            raise ValueError(f"{fmt}: its nested image is {inner} "
                             f"(conversion from {inner} to RGB not "
                             f"supported)")
        return inner, px, palette
    n = len(mode)
    if not -n <= band < n:
        raise ValueError(f"{fmt}: band {band} of a {n}-band image")
    if band not in (0, -n) and inner != "L":
        raise ValueError(f"{fmt}: its nested image is {inner}, not L (mode "
                         f"mismatch)")
    if inner in ("I", "F"):
        raise ValueError(f"{fmt}: a nested {inner} image as band 0, whose "
                         f"rows Pillow's merge reads as bytes through a "
                         f"pointer it never set (the process dies)")
    merged = modes.merge_band(inner, px)
    if merged is None:
        raise ValueError(f"{fmt}: its nested image is {inner}, not of one "
                         f"band (image has wrong mode)")
    bands = [np.zeros(merged.shape, np.uint8)] * n
    bands[band] = merged
    if mode == "CMYK":
        return mode, modes.cmyk_to_rgb(*bands), None
    return mode, np.stack(bands, -1), None
