"""JPEG textures without Pillow: the decoder of the native host library
(cge_tpu_torch/native/cge_jpeg.cpp), which decodes as libjpeg-turbo does
with the defaults Pillow runs it with, so the texels equal the JAX
package's `load_image` (Pillow's `convert("RGB")`) byte for byte.

It reads every JPEG that Pillow opens: sequential and progressive DCT with
Huffman or arithmetic coding (with DAC conditioning and restart
intervals), and sequential lossless (predictors 1 to 7, point
transforms); 8-bit samples; grey, three components (JFIF YCbCr, Adobe RGB
or YCbCr, or as the component ids say) or four (CMYK, or YCCK under an
Adobe marker of transform 2), at every whole sampling ratio; progressive
files whose scans leave a low coefficient unrefined are smoothed as
libjpeg smooths them. Entropy decoding is byte-serial, so all of it runs
in C++: the islow IDCT, the upsampling libjpeg picks for each component
and the fixed-point YCbCr -> RGB and YCCK -> CMYK tables. Four components
come out as CMYK, and Pillow's reading of them ("CMYK;I", Adobe's
inverted CMYK) and its conversion to RGB follow here, with scene/modes.py's
copy of Pillow's cmyk2rgb.

Before libjpeg reads a file, Pillow walks its markers up to the first
scan in Python (JpegImagePlugin._open), then reads the dpi from an Exif
segment where JFIF gave none (_read_dpi_from_exif), and Image.open's
jpeg_factory reads an MPF segment's index (_getmp), making the file an
MPO, whose frame 0 is the same bytes. pillow_open and jpeg_factory follow
them,
and a file they cannot open raises native.NotOpened naming the case (a
marker not in Pillow's table, such as TEM, a frame header of other than
8 bits or of 2 components, a DQT table or a JFIF, Adobe, ICC or Photoshop
segment cut before what Pillow reads of it, an EXIF XResolution too short
to index, MP entries shorter than their count), so that Image.open's next
plugin is tried; BLP's JPEG, which Pillow opens as a JpegImageFile of its
own, skips jpeg_factory.

What Pillow refuses raises a ValueError that names the case: 12- and
16-bit samples, two components, hierarchical JPEG, lossless arithmetic
coding, fractional sampling ratios, a DNL marker, lossless YCbCr or YCCK,
an arithmetic-coded scan that runs past the 64 KB blocks in which Pillow
hands the file to libjpeg (jdarith.c cannot wait for the next block), and
Huffman data that end (no EOI) where libjpeg's bit buffer reads ahead
before the last MCU, or in a file of several scans at all. The library is
built at first use (native.library()); a failed build raises, and nothing
falls back.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes, tiff


# the markers JpegImagePlugin's table names (MARKER), each with the handler
# Pillow runs on it: "skip" the segment, "app", "com", "sof", "dqt", or
# None (the marker alone)
_MARKERS = {0xC4: "skip", 0xC8: None, 0xCC: "skip", 0xD8: None, 0xD9: None,
            0xDA: "skip", 0xDB: "dqt", 0xDC: "skip", 0xDD: "skip",
            0xDE: "sof", 0xDF: "skip", 0xFE: "com"}
_MARKERS.update({m: "sof" for m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                                    0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)})
_MARKERS.update({m: None for m in range(0xD0, 0xD8)})
_MARKERS.update({m: "app" for m in range(0xE0, 0xF0)})
_MARKERS.update({m: None for m in range(0xF0, 0xFE)})


def _segment(data: bytes, pos: int) -> tuple[bytes, int]:
    """JpegImagePlugin's `n = i16(fp.read(2)) - 2; ImageFile._safe_read(fp,
    n)`: the segment and the position past it; native.NotOpened where the
    length is cut short (struct.error), ValueError where the segment is
    (OSError "Truncated File Read")."""
    if pos + 2 > len(data):
        raise native.NotOpened("JPEG marker segment length cut short")
    n = int.from_bytes(data[pos:pos + 2], "big") - 2
    pos += 2
    if n <= 0:
        return b"", pos
    if pos + n > len(data):
        raise ValueError(f"JPEG marker segment of {n} bytes is truncated")
    return data[pos:pos + n], pos + n


def _app(marker: int, s: bytes, icc: list, info: dict) -> None:
    """JpegImagePlugin.APP's reads that can fail: JFIF's and Adobe's version
    (struct.error), the Photoshop resources' name lengths (IndexError); and
    what _read_dpi_from_exif and jpeg_factory read later: whether JFIF set
    "dpi" (a density unit of 1 or 2 and both densities there), the EXIF
    data (the first Exif segment, then the others' bytes after their
    "Exif\\0\\0"), the last MPF segment's bytes after "MPF\\0", the APP1
    segments."""
    if marker == 0xE1:
        info["app1"].append(s)
    if (marker == 0xE0 and s.startswith(b"JFIF")) or (
            marker == 0xEE and s.startswith(b"Adobe")):
        if len(s) < 7:
            raise native.NotOpened(f"JPEG APP{marker & 15} segment of "
                                   f"{len(s)} bytes cut before its version")
        if marker == 0xE0 and len(s) >= 12 and s[7] in (1, 2):
            info["dpi"] = True
    elif marker == 0xE1 and s.startswith(b"Exif\0\0"):
        info["exif"] = s if info["exif"] is None else info["exif"] + s[6:]
    elif marker == 0xE2 and s.startswith(b"ICC_PROFILE\0"):
        icc.append(s)
    elif marker == 0xE2 and s.startswith(b"MPF\0"):
        info["mp"] = s[4:]
    elif marker == 0xED and s.startswith(b"Photoshop 3.0\x00"):
        offset = 14
        while s[offset:offset + 4] == b"8BIM":
            offset += 4
            if offset + 2 > len(s):
                return                             # struct.error: caught
            code = int.from_bytes(s[offset:offset + 2], "big")
            offset += 2
            if offset >= len(s):
                raise native.NotOpened("JPEG Photoshop resource cut before "
                                       "its name")
            offset += 1 + s[offset]
            offset += offset & 1
            if offset + 4 > len(s):
                return
            size = int.from_bytes(s[offset:offset + 4], "big")
            offset += 4
            if code == 0x03ED and len(s[offset:offset + size]) < 14:
                return                             # ResolutionInfo cut
            offset += size
            offset += offset & 1


def pillow_open(data: bytes) -> tuple:
    """JpegImagePlugin.JpegImageFile._open, Pillow's own walk of the
    markers before the first scan, in Python, before libjpeg reads any:
    junk bytes skipped to an 0xFF, fill bytes (0xFFFF) and escaped 0xFF
    (0xFF00) passed over, each marker of its table handled (a segment read
    for DHT, DAC, DNL, DRI, EXP and SOS; APPn, COM, SOFn, DHP and DQT
    parsed), up to the first SOS, then _read_dpi_from_exif (exif_dpi).
    native.NotOpened where Pillow's _open raises SyntaxError, IndexError
    or struct.error (Image.open then tries the next plugin): a marker it
    has not in its table (TEM, the reserved ones), a file that ends before
    its SOS, a frame header of other than 8-bit samples or 1, 3 or 4
    components or cut short, a DQT table cut short, a JFIF or Adobe
    segment cut before its version, an ICC profile chunk cut before its
    sequence numbers, a Photoshop resource cut before its name, an EXIF
    XResolution too short to index; ValueError where a segment is cut by
    the end of the file. (Pillow's mode, the last frame header's: L, RGB
    or CMYK for 1, 3 or 4 components; _app's info.)"""
    pos, s, mode = 3, b"\xff", ""
    icc: list = []
    info = {"dpi": False, "exif": None, "mp": None, "app1": []}
    while True:
        if not s:
            raise native.NotOpened("JPEG file ends before its first scan")
        if s[0] != 0xFF:                           # junk: on to an 0xFF
            at = data.find(b"\xff", pos)
            if at < 0:
                raise native.NotOpened("JPEG file ends before its first "
                                       "scan")
            pos, s = at + 1, b"\xff"
            continue
        s += data[pos:pos + 1]
        pos += len(s) - 1
        if len(s) < 2:
            raise native.NotOpened("JPEG file ends inside a marker")
        m = s[1]
        if m in _MARKERS:
            kind = _MARKERS[m]
            if kind is not None:
                seg, pos = _segment(data, pos)
                if kind == "app":
                    _app(m, seg, icc, info)
                elif kind == "sof":
                    mode = _sof(m, seg, icc)
                    icc = []
                elif kind == "dqt":
                    _dqt(seg)
            if m == 0xDA:
                break
            s = data[pos:pos + 1]
            pos += len(s)
        elif m == 0xFF:
            s = b"\xff"
        elif m == 0x00:
            s = data[pos:pos + 1]
            pos += len(s)
        else:
            raise native.NotOpened(f"JPEG marker 0xFF{m:02X} before the first "
                                   f"scan is not one Pillow knows (no marker "
                                   f"found)")
    if not info["dpi"] and info["exif"] is not None:
        exif_dpi(info["exif"])
    return mode, info


# Pillow's ImageFileDirectory_v2: the value size of each field type it
# loads (the others it skips)
_IFD_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8}


def _directory(data: bytes):
    """The tags ImageFileDirectory_v2 loads from a TIFF header and its first
    IFD (as Exif.load and _getmp read them): {tag: (type, value bytes)},
    the entries up to the first one cut short; None where the header is
    not a TIFF one Pillow takes (its SyntaxError, or struct.error at a
    header of under 8 bytes or a BigTIFF one, whose offset lies past the
    8 bytes read)."""
    head = data[:8]
    if not head.startswith(tiff.PREFIXES) or len(head) < 8 or head[2] == 43:
        return None
    order = "<" if head[:2] == b"II" else ">"
    tags = {}
    try:
        for tag, typ, _, value in tiff.ifd_entries(
                data, int.from_bytes(head[4:], "little" if order == "<"
                                     else "big"), order, _IFD_SIZES):
            if value is None:
                break                             # OSError: load stops
            if value:
                tags[tag] = (typ, value)
    except struct.error:                          # OSError: load stops
        pass
    return tags


def _single(typ: int, value: bytes, order: str):
    """A length-1 tag's value as ImageFileDirectory_v2 gives it: bytes for
    BYTE and UNDEFINED, a str for ASCII (one trailing NUL dropped), else
    the first number (an int, a float, or a rational as a (num, den)
    pair)."""
    if typ in (1, 7):
        return value
    if typ == 2:
        return (value[:-1] if value.endswith(b"\0") else value).decode(
            "latin-1")
    if typ in (5, 10):
        return struct.unpack_from(order + ("LL" if typ == 5 else "ll"),
                                  value)
    code = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d",
            13: "L", 16: "Q"}[typ]
    return struct.unpack_from(order + code, value)[0]


def exif_dpi(exif: bytes) -> None:
    """JpegImageFile._read_dpi_from_exif where JFIF set no "dpi": IFD0's
    ResolutionUnit, then XResolution, whose float([0]) / [1] is taken.
    native.NotOpened where that raises IndexError, which the method does
    not catch (ImageFile turns it into a SyntaxError and Image.open tries
    the next plugin): an XResolution of one BYTE or UNDEFINED byte, or of
    ASCII (one trailing NUL dropped) that is empty or one digit. What the
    method catches (struct.error, KeyError, SyntaxError, TypeError,
    ValueError, ZeroDivisionError) only sets the dpi, which the pixels do
    not use."""
    while exif.startswith(b"Exif\0\0"):
        exif = exif[6:]
    tags = _directory(exif) if exif else None
    if not tags or 0x0128 not in tags or 0x011A not in tags:
        return
    typ, value = tags[0x011A]
    x = _single(typ, value, "<" if exif[:2] == b"II" else ">")
    # float(x[0]) comes before x[1]: a lone character that is no number
    # raises ValueError first
    if isinstance(x, bytes) and len(x) < 2 or isinstance(x, str) and (
            not x or len(x) == 1 and x in "0123456789"):
        raise native.NotOpened(f"JPEG EXIF XResolution {x!r} is too short "
                               f"to index (IndexError in "
                               f"_read_dpi_from_exif)")


def jpeg_factory(data: bytes) -> str:
    """JpegImagePlugin.jpeg_factory: the file opened (pillow_open), then
    _getmp's reading of its last MPF segment's TIFF directory: "MPO" where
    it counts more than one image of JPEG entries and no APP1 segment
    holds an Ultra HDR `hdrgm:Version="` (MpoImageFile decodes frame 0,
    the bytes from the start of the file, as the JPEG would be), else
    "JPEG".
    Where _getmp raises SyntaxError (an unreadable directory, no
    NumberOfImages or MPEntry, an entry of a format other than JPEG),
    TypeError or IndexError, the file stays a JPEG; native.NotOpened where
    it raises struct.error, which jpeg_factory does not catch: MP entries
    shorter than 16 bytes an image (Image.open then tries the next
    plugin)."""
    _, info = pillow_open(data)
    mp = info["mp"]
    if mp is None:
        return "JPEG"
    tags = _directory(mp)
    if tags is None or 0xB001 not in tags or 0xB002 not in tags:
        return "JPEG"
    order = ">" if mp.startswith(b"MM\0*") else "<"
    quant = _single(*tags[0xB001], "<" if mp[:2] == b"II" else ">")
    entries = _single(*tags[0xB002], "<" if mp[:2] == b"II" else ">")
    if not isinstance(quant, int):
        return "JPEG"                                  # TypeError
    for k in range(max(quant, 0)):
        if not isinstance(entries, bytes):
            return "JPEG"                              # TypeError
        if len(entries) < 16 * k + 16:
            raise native.NotOpened(
                f"JPEG MPF index of {quant} images holds {len(entries)} "
                f"bytes of MP entries (struct.error in _getmp)")
        attribute = struct.unpack_from(order + "L", entries, 16 * k)[0]
        if (attribute >> 24) & 7:
            return "JPEG"                              # SyntaxError
    if quant > 1 and not any(b' hdrgm:Version="' in s for s in info["app1"]):
        return "MPO"
    return "JPEG"


def _sof(marker: int, s: bytes, icc: list) -> str:
    name = "DHP" if marker == 0xDE else f"SOF{marker - 0xC0}"
    if len(s) < 5:
        raise native.NotOpened(f"JPEG {name} segment of {len(s)} bytes is "
                               f"cut before its size")
    if s[0] != 8:
        raise native.NotOpened(f"{s[0]}-bit JPEG ({name}) is not supported "
                               f"(Pillow reads 8-bit samples only)")
    if len(s) < 6:
        raise native.NotOpened(f"JPEG {name} segment cut before its "
                               f"components")
    if s[5] not in (1, 3, 4):
        raise native.NotOpened(f"{s[5]}-component JPEG ({name}) is not "
                               f"supported (Pillow reads 1, 3 and 4 "
                               f"components)")
    if icc and len(sorted(icc)[0]) < 14:
        raise native.NotOpened("JPEG ICC profile chunk cut before its "
                               "sequence numbers")
    return {1: "L", 3: "RGB", 4: "CMYK"}[s[5]]


def _dqt(s: bytes) -> None:
    while s:
        size = 1 + (64 if s[0] < 16 else 128)
        if len(s) < size:
            raise native.NotOpened("JPEG DQT table cut short (bad "
                                   "quantization table marker)")
        s = s[size:]


def decode_file(data: bytes) -> np.ndarray:
    """A file Image.open opens as JPEG or MPO (jpeg_factory) -> [H, W, 3]
    uint8 RGB: an MPO's frame 0 is the same bytes as the JPEG's."""
    return modes.rgb(*open_file(data))


def open_file(data: bytes) -> tuple:
    """That file as Pillow opens it (mode, pixels, palette; modes.rgb): L
    as its band, RGB and CMYK converted."""
    jpeg_factory(data)
    mode = pillow_open(data)[0]
    rgb = decode_jpeg(data)
    return (mode, rgb[..., 0], None) if mode == "L" else (mode, rgb, None)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes, as a JpegImageFile reads them (BLP's JPEG too,
    which jpeg_factory never sees) -> [H, W, 3] uint8 RGB, row 0 the
    top."""
    pillow_open(data)
    lib = native.library()
    info = np.zeros(3, np.intc)
    native.decode_call(lib.cge_jpeg_info, data, len(data), info.ctypes.data)
    w, h, channels = (int(v) for v in info)
    native.check_pixels("JPEG", w, h)
    out = np.empty((h, w, channels), np.uint8)
    native.decode_call(lib.cge_jpeg_decode, data, len(data), out.ctypes.data,
                       out.size)
    if channels == 4:
        # Pillow: rawmode "CMYK;I" (inverted), then convert("RGB")
        return modes.cmyk_to_rgb(*(255 - out[..., k] for k in range(4)))
    return out
