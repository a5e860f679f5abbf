"""IFUNC Image Memory files (.im) without Pillow, as Pillow 12's
ImImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

IM has no signature: Image.open tries the plugin on every file that
reaches it (after ICO, before IM Tools). Its header is text: a newline in
the first 100 bytes, then lines of at most 100 bytes (a lone carriage
return before one passed over), each "Key: value" (Pillow's `split`
expression), up to a NUL, a 0x1A or the file's end; at least one of its
nine standard keys. "Image type" names the mode and its raw layout from
Pillow's OPEN table, "Image size (x*y)" the size (each value Python's
int(), else float(); defaults L and 512 x 512). The pixels start after
the next 0x1A, past a 768-byte palette where a "Lut" line is present
(256 reds, greens and blues): one that is not grey turns L and P into P
(8-bit indices, whatever the type's layout) and LA into PA; a grey one
that is not the identity is kept by Pillow and applied by nothing.

Only the first frame is read, rows from the bottom, each in its raw
layout: "1" (bits, most significant first), L, RGB, and the line-
interleaved RGB;L, LA;L, PA;L, RGBA;L, RGBX;L, CMYK;L and YCbCr;L (each
row a plane a band), P;2 and P;4 (a P image of no palette, so black),
I;16 / I;16L / I;16B, I;32 / I;32S, F;8, F;8S, F;16, F;16S, F;32 and
F;32F; RGB;T and RYB;T (three planes of the whole image, read as green,
then red, then blue); and F;2 to F;31 but 8 and 16, through Pillow's bit
decoder (native.bit_decode, in cge_raster.cpp); and a bare "LAB" type
read with the L layout (Pillow's band 0 unpacker: the bytes are L, a and b
stay 0; a Lut is skipped and changes nothing). The samples become RGB as
convert("RGB") makes them (modes.py): F clamped and truncated (a NaN
refused), I and I;16 saturated, CMYK and YCbCr through Pillow's tables,
alpha dropped, LAB through LittleCMS's Lab -> sRGB (lcms.lab_to_rgb).

A header Pillow's plugin does not open (no newline in the first 100
bytes, a line too long or of no key, no standard key, no 0x1A, a palette
cut short where Pillow indexes past its end, a size of one value, no mode,
an empty image) is native.NotOpened, so Image.open goes on to the next
format. What escapes Image.open raises a ValueError naming IM: a size,
scale or frame count neither int() nor float() reads, a size past
Pillow's limit, a size that is not two whole numbers, a type whose layout
Pillow has no unpacker for (RLB, PA;L into LA, a bare mode name whose
layout it cannot unpack into), data cut short.
"""

from __future__ import annotations

import re

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import lcms, modes

# ImImagePlugin's standard keys
COMMENT, DATE, EQUIPMENT = "Comment", "Date", "Digitalization equipment"
FRAMES, LUT, NAME = "File size (no of images)", "Lut", "Name"
SCALE, SIZE, MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
TAGS = (COMMENT, DATE, EQUIPMENT, FRAMES, LUT, NAME, SCALE, SIZE, MODE)

# ImImagePlugin.OPEN: image type -> (mode, raw layout)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# (mode, raw layout) -> (bits a pixel, how the row's bytes read): "planes"
# n reads n line-interleaved planes of bytes, a numpy type its samples.
# The pairs of OPEN and the Lut, and those Pillow also unpacks where a type
# outside OPEN (a bare mode name) follows another type's line, which left
# its layout (RGBX and RGBA take RGB's layouts, I and I;16 16-bit ones)
_LAYOUTS = {
    ("1", "1"): (1, "bits"), ("L", "L"): (8, "u1"), ("P", "P"): (8, "u1"),
    ("P", "L"): (8, "u1"), ("P", "P;2"): (2, "black"),
    ("P", "P;4"): (4, "black"), ("RGB", "RGB"): (24, "packed"),
    ("RGBX", "RGB"): (24, "packed"), ("RGB", "RGB;L"): (24, "planes"),
    ("RGBX", "RGB;L"): (24, "planes"), ("RGB", "RGBX;L"): (32, "planes"),
    ("RGBX", "RGBX;L"): (32, "planes"), ("RGB", "RGBA;L"): (32, "planes"),
    ("RGBA", "RGBA;L"): (32, "planes"), ("CMYK", "CMYK;L"): (32, "planes"),
    ("YCbCr", "YCbCr;L"): (24, "planes"), ("LA", "LA;L"): (16, "planes"),
    ("PA", "PA;L"): (16, "planes"), ("I;16", "I;16"): (16, "<u2"),
    ("I;16L", "I;16L"): (16, "<u2"), ("I;16B", "I;16B"): (16, ">u2"),
    ("I;16", "I;16B"): (16, ">u2"), ("I", "I;16"): (16, "<u2"),
    ("I", "I;16B"): (16, ">u2"), ("I", "I;32"): (32, "<i4"),
    ("I", "I;32S"): (32, "<i4"), ("LAB", "L"): (8, "u1"),
    ("F", "F;8"): (8, "u1"),
    ("F", "F;8S"): (8, "i1"), ("F", "F;16"): (16, "<u2"),
    ("F", "F;16S"): (16, "<i2"), ("F", "F;32"): (32, "<u4"),
    ("F", "F;32F"): (32, "<f4")}


def _number(s: str):
    """ImImagePlugin.number."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def _grey_lut(palette: bytes) -> tuple:
    """_open's scan of the Lut: (grey, linear); IndexError where it reads
    past the palette's end, as Pillow's does."""
    grey = linear = True
    for i in range(256):
        if palette[i] == palette[i + 256] == palette[i + 512]:
            if palette[i] != i:
                linear = False
        else:
            grey = False
    return grey, linear


def header(data: bytes) -> dict:
    """ImImageFile._open and the checks after it: {"size", "mode",
    "rawmode", "type", "offset", "palette"}; native.NotOpened where Pillow's
    plugin does not open the file, ValueError where it raises what escapes
    Image.open."""
    if b"\n" not in data[:100]:
        raise native.NotOpened("not an IM file (no newline in its first 100 "
                               "bytes)")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, kind, n, pos = "L", "L (the default)", 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise native.NotOpened("not an IM file (a header line of over "
                                   "100 bytes)")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise native.NotOpened(f"Syntax error in IM header: {s[:40]!r}")
        k, v = (x.decode("latin-1", "replace") for x in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as e:
                raise ValueError(f"IM header {k!r}: {e}") from None
            if len(v) == 1:
                v = v[0]
        elif k == MODE:
            kind = v
            if v in OPEN:
                v, rawmode = OPEN[v]
        if k != COMMENT:
            info[k] = v
        n += k in TAGS
    if not n:
        raise native.NotOpened("Not an IM file (no standard key)")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise native.NotOpened("IM header without 0x1A (File truncated)")
    palette = None
    if LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        try:
            grey, linear = _grey_lut(lut)
        except IndexError:
            raise native.NotOpened(f"IM Lut of {len(lut)} bytes") from None
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = (("P", "P") if mode in ("L", "P")
                             else ("PA", "PA;L"))
            palette = lut
    if not isinstance(size, tuple):
        raise native.NotOpened(f"IM size {size!r} of one value")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise native.NotOpened(f"IM of mode {mode!r} and size {size}")
    if max(1, size[0]) * max(1, size[1]) > native.MAX_PIXELS:
        raise ValueError(f"IM of {size} pixels: past Pillow's limit of "
                         f"{native.MAX_PIXELS} pixels")
    return dict(size=size, mode=mode, rawmode=rawmode, type=kind,
                offset=pos, palette=palette)


def _planes(rows: np.ndarray, w: int, n: int) -> list:
    return [rows[:, k * w:(k + 1) * w] for k in range(n)]


def open_im(data: bytes) -> tuple:
    """IM bytes -> the first frame as Pillow opens it (mode, pixels,
    palette; modes.rgb), row 0 = top: 1, L, P (black without a Lut) and
    the I;16 modes as their band, the other modes converted."""
    head = header(data)
    size, mode, rawmode = head["size"], head["mode"], head["rawmode"]
    fmt = f"IM ({head['type']!r}, {mode} from {rawmode})"
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"{fmt} of size {size}: not two whole numbers")
    w, h = size
    native.check_pixels(fmt, w, h)
    offset = head["offset"]
    if rawmode in ("RGB;T", "RYB;T") and mode in ("RGB", "RGBA", "RGBX"):
        planes = native.raw_rows(data, offset, 3 * h, w, w, fmt)
        g, r, b = (planes[k * h:(k + 1) * h][::-1] for k in range(3))
        return mode, np.stack([r, g, b], -1), None
    if mode == "F" and rawmode.startswith("F;") and rawmode[2:].isdigit() \
            and int(rawmode[2:]) not in (8, 16, 32):
        px = native.bit_decode(data, offset, int(rawmode[2:]), w, h, fmt)
        return mode, modes.grey(modes.f_to_u8(px, fmt)), None
    if (mode, rawmode) not in _LAYOUTS:
        raise ValueError(f"{fmt}: Pillow has no unpacker of {rawmode} into "
                         f"{mode} (unknown raw mode for given image mode)")
    bits, layout = _LAYOUTS[mode, rawmode]
    rb = (w * bits + 7) // 8
    rows = native.raw_rows(data, offset, h, rb, rb, fmt)[::-1]
    if layout == "bits":
        return mode, np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255), None
    if layout == "black":                 # P;2 and P;4: indices, no palette
        idx = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        idx = (idx << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)
        return mode, idx, _palette(None)
    if layout == "packed":
        return mode, np.ascontiguousarray(rows.reshape(h, w, 3)), None
    if layout == "planes":
        p = _planes(rows, w, bits // 8)
        if mode == "CMYK":
            return mode, modes.cmyk_to_rgb(*p), None
        if mode == "YCbCr":
            return mode, modes.ycbcr_to_rgb(*p), None
        if mode in ("RGB", "RGBA", "RGBX"):
            return mode, np.stack(p[:3], -1), None
        if mode == "LA":
            return mode, modes.grey(p[0]), None
        return mode, _palette(head["palette"])[p[0]], None    # PA
    px = np.ascontiguousarray(rows).view(layout).reshape(h, w)
    if mode == "P":
        return mode, px, _palette(head["palette"])
    if mode == "L" or mode in modes.WORD_MODES:
        return mode, px, None
    if mode == "LAB":                     # the L band; a and b stay 0
        lab = np.zeros((256, 3), np.uint8)
        lab[:, 0] = np.arange(256)
        return mode, lcms.lab_to_rgb(lab)[px], None
    if mode == "F":
        return mode, modes.grey(modes.f_to_u8(px.astype(np.float32), fmt)), \
            None
    return mode, modes.grey(modes.i_to_u8(px)), None


def _palette(lut) -> np.ndarray:
    """The Lut's 768 bytes (red, green and blue planes) as [256, 3]; black
    where there is none (a P or PA image of no palette)."""
    if lut is None:
        return np.zeros((256, 3), np.uint8)
    return np.frombuffer(lut, np.uint8).reshape(3, 256).T
