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
scan in Python (JpegImagePlugin._open); pillow_open follows that walk, and
a file it cannot open raises native.NotOpened naming the case (a marker
not in Pillow's table, such as TEM, a frame header of other than 8 bits
or of 2 components, a DQT table or a JFIF, Adobe, ICC or Photoshop
segment cut before what Pillow reads of it), so that Image.open's next
plugin is tried.

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

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes


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


def _app(marker: int, s: bytes, icc: list) -> None:
    """JpegImagePlugin.APP's reads that can fail: JFIF's and Adobe's version
    (struct.error), the Photoshop resources' name lengths (IndexError)."""
    if (marker == 0xE0 and s.startswith(b"JFIF")) or (
            marker == 0xEE and s.startswith(b"Adobe")):
        if len(s) < 7:
            raise native.NotOpened(f"JPEG APP{marker & 15} segment of "
                                   f"{len(s)} bytes cut before its version")
    elif marker == 0xE2 and s.startswith(b"ICC_PROFILE\0"):
        icc.append(s)
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


def pillow_open(data: bytes) -> str:
    """JpegImagePlugin.JpegImageFile._open, Pillow's own walk of the
    markers before the first scan, in Python, before libjpeg reads any:
    junk bytes skipped to an 0xFF, fill bytes (0xFFFF) and escaped 0xFF
    (0xFF00) passed over, each marker of its table handled (a segment read
    for DHT, DAC, DNL, DRI, EXP and SOS; APPn, COM, SOFn, DHP and DQT
    parsed), up to the first SOS. native.NotOpened where Pillow's _open
    raises SyntaxError, IndexError or struct.error (Image.open then tries
    the next plugin): a marker it has not in its table (TEM, the reserved
    ones), a file that ends before its SOS, a frame header of other than
    8-bit samples or 1, 3 or 4 components or cut short, a DQT table cut
    short, a JFIF or Adobe segment cut before its version, an ICC profile
    chunk cut before its sequence numbers, a Photoshop resource cut before
    its name; ValueError where a segment is cut by the end of the file.
    Pillow's mode, the last frame header's: L, RGB or CMYK for 1, 3 or 4
    components."""
    pos, s, mode = 3, b"\xff", ""
    icc: list = []
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
                    _app(m, seg, icc)
                elif kind == "sof":
                    mode = _sof(m, seg, icc)
                    icc = []
                elif kind == "dqt":
                    _dqt(seg)
            if m == 0xDA:
                return mode
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


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> [H, W, 3] uint8 RGB, row 0 the top."""
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
