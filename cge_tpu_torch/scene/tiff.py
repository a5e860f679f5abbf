"""TIFF textures without Pillow: the first image file directory, as Pillow
12's TiffImagePlugin reads it (through libtiff 4.7 for every compression
but raw) and `convert("RGB")` converts it (the JAX package's loader).

The header (II or MM; classic or BigTIFF, which Pillow knows by a third
byte of 43, so a big-endian BigTIFF reads as classic and fails, as in
Pillow; libtiff, which reads the header again, refuses what it reads
otherwise) and the first IFD are parsed as Pillow parses them, and the
mode and raw mode come from the key (byte order, photometric, sample
format, fill order, bits, extra samples) through OPEN_INFO, the part of
Pillow's table that this module converts. Three readers follow Pillow's:

  raw (compression 1)   Pillow's own: strips or tiles at their offsets,
        rows of the raw mode's bits (a layer's raw mode, one letter of the
        image's, for PlanarConfiguration 2), FillOrder 2 through the raw
        modes that reverse bits; the Predictor tag is ignored; YCbCr as
        raw mode RGBX, which reads past Pillow's own files' data.
  libtiff   each strip or tile of StripByteCounts bytes, its bits reversed
        first at FillOrder 2 (but JPEG's), decoded to its whole size:
          LZW 5, PackBits 32773       native library (cge_image.cpp);
          Deflate 8, 32946 and LZMA 34925 (an .xz stream)   zlib and lzma;
          ZSTD 50000    native library (cge_zstd.cpp): the first frame,
                        as libtiff streams it through libzstd;
          CCITT RLE 2, Group 3 (1D, or 2D by T4Options bit 0, fill bits
                        or none) and Group 4   native library
                        (cge_fax.cpp), 1-bit samples, libtiff's repairs of
                        damaged rows and its no-EOL mode;
          JPEG 7        the JPEG decoder of cge_jpeg.cpp after the
                        JPEGTables stream, no colour conversion but YCbCr
                        -> RGB at PlanarConfiguration 1 (Pillow's raw mode
                        RGB there), each stream as tall as its strip (a last
                        strip's may run past the image) or a whole tile;
          ThunderScan 32809   native library (cge_raster.cpp), 4-bit
                        samples in strips;
        Predictor 2 or 3 undone row by row for LZW, Deflate, LZMA and ZSTD
        (libtiff ignores it for the others), samples in little-endian
        order, then Pillow's raw mode with ";16B" and ";16L" (and "I;16")
        read as native, the others as written, which is how Pillow reads
        them. PlanarConfiguration 2 at 8 or 16 bits reads one plane a
        band, its high byte at 16 bits, and un-premultiplies RGBa after.
  RGBA (YCbCr, compressed but JPEG at PlanarConfiguration 1)   Pillow's
        _decodeAsRGBA: libtiff's TIFFRGBAImage a strip or tile row at a
        time, 8-bit samples subsampled 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 or 4x4
        (1x1 only in planes), tif_color.c's fixed-point YCbCrToRGB of
        YCbCrCoefficients and ReferenceBlackWhite, chroma held over its
        block, and libtiff's quirks (see _read_ycbcr); a strip that fails
        to decode is read as libtiff hands it over, what was decoded and
        zeros after, since Pillow asks libtiff not to stop there (but a
        ZSTD one: that raises). JPEG in planes is a one-component stream a
        plane.
  old-style JPEG (6)   ojpeg.py: the JPEG stream libtiff's OJPEG codec
        builds (from a JPEGInterchangeFormat header, the strips' own
        markers or the tables in tags) through cge_jpeg.cpp; grey as it
        comes, YCbCr (Pillow takes every such file as YCbCr; libtiff takes
        photometric RGB as YCbCr) as raw data through the RGBA path.

`convert("RGB")` then: 1-bit to 0 / 255, 2- and 4-bit grey scaled by 85 and
17, MinIsWhite inverted where the raw mode says so, the palette from the
16-bit ColorMap's high bytes, 16-bit grey saturated at 255, signed and
32-bit integers clipped to [0, 255], floats truncated and clipped (NaN to
0), the other 16-bit samples' high bytes, associated alpha divided out
(v x 255 // a), CMYK through Pillow's conversion (modes.py), CIE L*a*b*
(photometric 8, 8 bits; a* and b* signed, as Pillow's LAB unpacker reads
them) through LittleCMS's Lab -> sRGB transform (lcms.py), alpha and
extra samples dropped; the Orientation tag then transposes the image, as
Pillow's exif_transpose does.

What Pillow or libtiff refuses raises a ValueError that names the case:
SGILog (34676, 34677: Pillow has no mode for LogL or LogLuv, and libtiff's
codec takes nothing else), WebP in TIFF (50001: Pillow's libtiff is built
without it), a key that Pillow does not know. So do the cases not ported:
the other compressions, old-style JPEG and ThunderScan in tiles or
planes. So do three cases where Pillow
returns pixels that no decoder wrote, or that libzstd's internals leave:
a Group 4 strip that ends before its last row, a JPEG stream smaller than
its strip or tile, and a ZSTD strip of the RGBA path that fails.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import lcms, modes, ojpeg

II, MM = b"II", b"MM"
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")

COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                8: "Adobe Deflate", 32771: "raw 16-bit padded",
                32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate",
                34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
                50000: "ZSTD", 50001: "WebP"}
DECODED = (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32809, 32946, 34925, 50000)
FAX = (2, 3, 4)
# compressions that undo a Predictor tag (libtiff's TIFFPredictorInit)
PREDICTED = (5, 8, 32946, 34925, 50000)


def _open_info() -> dict:
    """Pillow's OPEN_INFO, the keys this module reads: (byte order,
    photometric, sample format, fill order, bits, extra samples) -> (mode,
    raw mode)."""
    table = {}

    def both(photo, fmt, fill, bits, extra, mode, raw):
        for order in (II, MM):
            table[(order, photo, fmt, fill, bits, extra)] = (mode, raw)

    for photo, inv in ((0, "I"), (1, "")):
        both(photo, (1,), 1, (1,), (), "1", "1;" + inv if inv else "1")
        both(photo, (1,), 2, (1,), (), "1", f"1;{inv}R")
        for bits in (2, 4):
            both(photo, (1,), 1, (bits,), (), "L", f"L;{bits}{inv}")
            both(photo, (1,), 2, (bits,), (), "L", f"L;{bits}{inv}R")
        both(photo, (1,), 1, (8,), (), "L", "L;" + inv if inv else "L")
        both(photo, (1,), 2, (8,), (), "L", f"L;{inv}R")
    both(1, (2,), 1, (8,), (), "L", "L")
    table[(II, 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
    table[(II, 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(II, 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(MM, 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    table[(II, 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    table[(II, 1, (2,), 1, (16,), ())] = ("I", "I;16S")
    table[(MM, 1, (2,), 1, (16,), ())] = ("I", "I;16BS")
    table[(II, 0, (3,), 1, (32,), ())] = ("F", "F;32F")
    table[(MM, 0, (3,), 1, (32,), ())] = ("F", "F;32BF")
    table[(II, 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    table[(II, 1, (2,), 1, (32,), ())] = ("I", "I;32S")
    table[(MM, 1, (2,), 1, (32,), ())] = ("I", "I;32BS")
    table[(II, 1, (3,), 1, (32,), ())] = ("F", "F;32F")
    table[(MM, 1, (3,), 1, (32,), ())] = ("F", "F;32BF")
    both(1, (1,), 1, (8, 8), (2,), "LA", "LA")
    both(2, (1,), 1, (8, 8, 8), (), "RGB", "RGB")
    both(2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R")
    both(2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA")
    for extra, mode, raw in (((0,), "RGB", "RGBX"), ((0, 0), "RGB", "RGBXX"),
                             ((0, 0, 0), "RGB", "RGBXXX"),
                             ((1,), "RGBA", "RGBa"),
                             ((1, 0), "RGBA", "RGBaX"),
                             ((1, 0, 0), "RGBA", "RGBaXX"),
                             ((2,), "RGBA", "RGBA"),
                             ((2, 0), "RGBA", "RGBAX"),
                             ((2, 0, 0), "RGBA", "RGBAXX"),
                             ((999,), "RGBA", "RGBA")):
        both(2, (1,), 1, (8,) * (3 + len(extra)), extra, mode, raw)
    for order, end in ((II, "L"), (MM, "B")):
        for extra, mode, raw in (((), "RGB", "RGB"), ((), "RGBA", "RGBA"),
                                 ((0,), "RGB", "RGBX"),
                                 ((1,), "RGBA", "RGBa"),
                                 ((2,), "RGBA", "RGBA")):
            n = len(raw)
            table[(order, 2, (1,), 1, (16,) * n, extra)] = (mode,
                                                            f"{raw};16{end}")
        table[(order, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", f"CMYK;16{end}")
    for bits, raw in ((1, "P;1"), (2, "P;2"), (4, "P;4")):
        both(3, (1,), 1, (bits,), (), "P", raw)
        both(3, (1,), 2, (bits,), (), "P", raw + "R")
    both(3, (1,), 1, (8,), (), "P", "P")
    both(3, (1,), 1, (8, 8), (0,), "P", "PX")
    both(3, (1,), 1, (8, 8), (2,), "PA", "PA")
    both(3, (1,), 2, (8,), (), "P", "P;R")
    both(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
    both(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
    both(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
    both(6, (1,), 1, (8,), (), "L", "L")
    both(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX")
    both(8, (1,), 1, (8, 8, 8), (), "LAB", "LAB")
    return table


OPEN_INFO = _open_info()
# (mode, raw mode) pairs that Pillow's table names but its unpackers lack,
# and the layers of separate planes that it cannot unpack
NO_UNPACKER = {("L", "L;IR"), ("P", "P;1R"), ("P", "P;2R"), ("P", "P;4R"),
               ("I;16", "I"), ("I;16B", "I"), ("LA", "L"), ("LA", "A"),
               ("PA", "P"), ("PA", "A"), ("RGBA", "a")}
# Pillow's mode -> its bands
BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "I;16": 1, "I;16B": 1, "F": 1,
         "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}

# IFD field types -> struct code (the others are skipped, as by Pillow)
_FIELD = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 16: "Q", 17: "q",
          7: "s"}
# tags Pillow gives as one value (TiffTags' length 1)
_SCALAR = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _ifd(data: bytes):
    """(byte order, tags {tag: value}) of the first IFD."""
    head = data[:8]
    if not head.startswith(PREFIXES):
        raise ValueError("not a TIFF file")
    order = "<" if head[:2] == II else ">"
    big = head[2] == 43                     # Pillow's test of the header
    if big:
        if len(data) < 16:
            raise ValueError("TIFF file is truncated in its header")
        pos = struct.unpack_from(order + "Q", data, 8)[0]
    else:
        pos = struct.unpack_from(order + "L", data, 4)[0]
    count_fmt, entry_fmt, inline = ("Q", "HHQ8s", 8) if big else \
        ("H", "HHL4s", 4)
    try:
        (n,) = struct.unpack_from(order + count_fmt, data, pos)
        pos += struct.calcsize("<" + count_fmt)
        tags = {}
        for _ in range(n):
            tag, typ, count, value = struct.unpack_from(order + entry_fmt,
                                                        data, pos)
            pos += struct.calcsize("<" + entry_fmt)
            if typ not in _FIELD and typ not in (5, 10):
                continue
            size = count * (8 if typ in (5, 10) else 1 if typ == 7 else
                            struct.calcsize("<" + _FIELD[typ]))
            if size > inline:
                (off,) = struct.unpack(order + ("Q" if big else "L"), value)
                value = data[off:off + size]
                if len(value) != size:
                    continue                    # Pillow skips such a tag
            if typ in (5, 10):               # libtiff's floats of rationals
                pairs = struct.unpack(order + ("L" if typ == 5 else "l")
                                      * (2 * count), value[:size])
                vals = tuple(float(np.float32(a) / np.float32(b)) if b else
                             0.0 for a, b in zip(pairs[::2], pairs[1::2]))
            elif typ == 7:                   # UNDEFINED: the bytes
                vals = (bytes(value[:size]),)
            else:
                vals = struct.unpack(order + _FIELD[typ] * count,
                                     value[:size])
            if vals:
                tags[tag] = vals[0] if (tag in _SCALAR and count == 1) or \
                    typ == 7 else vals
    except struct.error:
        raise ValueError("TIFF file is truncated in its first IFD") from None
    return head[:2], order, tags


def _unpack_bits(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """rows [h, n] uint8 -> [h, width] samples of bits (MSB first)."""
    h = rows.shape[0]
    b = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(h, width, bits)
    return (b.astype(np.uint32) << np.arange(bits - 1, -1, -1,
                                             dtype=np.uint32)).sum(-1)


def _samples(rows: np.ndarray, width: int, size: int, end: str,
             kind: str = "u") -> np.ndarray:
    """rows [h, n] uint8 -> [h, width x k] samples of size bytes."""
    h = rows.shape[0]
    n = rows.shape[1] // size * size
    dt = np.dtype(f"{end}{kind}{size}")
    return np.ascontiguousarray(rows[:, :n]).view(dt).reshape(h, -1)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Pillow's RGBa unpacking: v x 255 // a, clipped; 0 where a is 0."""
    a = a.astype(np.int32)[..., None]
    v = rgb.astype(np.int32) * 255 // np.maximum(a, 1)
    return np.where(a == 0, 0, np.minimum(v, 255)).astype(np.uint8)


# raw mode -> its bits a pixel (Pillow's unpackers)
RAW_BITS = {"1": 1, "L": 8, "P": 8, "F": 32, "PX": 16, "PA": 16, "LA": 16,
            "I;12": 12, "I;16": 16, "I;16N": 16, "I;16B": 16, "I;16R": 16,
            "I;16S": 16, "I;16BS": 16, "I;32N": 32, "I;32S": 32,
            "I;32BS": 32, "F;32F": 32, "F;32BF": 32, "RGB": 24, "RGB;R": 24,
            "RGBA": 32, "RGBX": 32, "RGBXX": 40, "RGBXXX": 48, "RGBa": 32,
            "RGBaX": 40, "RGBaXX": 48, "RGBAX": 40, "RGBAXX": 48,
            "CMYK": 32, "CMYKX": 40, "CMYKXX": 48, "LAB": 24}


def raw_bits(raw: str) -> int:
    if raw in RAW_BITS:
        return RAW_BITS[raw]
    base = raw.split(";")[0]
    if raw[:2] in ("L;", "P;") and raw[2:3].isdigit():
        return int(raw[2])
    if raw.startswith("1;"):
        return 1
    if raw in ("L;I", "L;R", "L;IR", "P;R"):
        return 8
    if raw.endswith(("16L", "16B", "16N")):
        return 16 * len(base)
    raise ValueError(f"TIFF raw mode {raw}")


def unpack(rows: np.ndarray, width: int, raw: str) -> np.ndarray:
    """Pillow's unpacker of raw mode raw: rows [h, n] uint8 -> the band
    values [h, width, bands] of the image's mode."""
    h = rows.shape[0]
    name, _, opts = raw.partition(";")
    if opts.endswith("R") and not opts.startswith("16"):
        rows = _REV[rows]
        opts = opts[:-1]
    if name in ("1", "L", "P") and not opts.startswith(("12", "16", "32")):
        bits = int(opts[0]) if opts[:1].isdigit() else (1 if name == "1"
                                                        else 8)
        px = (_unpack_bits(rows, width, bits) if bits < 8
              else rows[:, :width].astype(np.uint32))
        if name == "P":
            return px[..., None].astype(np.uint8)
        scale = 255 // ((1 << bits) - 1)
        v = (px * scale).astype(np.uint8)
        if "I" in opts:
            v = 255 - v
        return v[..., None]
    if name in ("PX", "PA", "LA"):
        return rows[:, :2 * width].reshape(h, width, 2)[..., :1 if name ==
                                                          "PX" else 2]
    if name == "I":
        if opts == "12":
            v = _unpack_bits(rows, width, 12)
        elif opts == "16R":
            v = _samples(_REV[rows], width, 2, "<")[:, :width]
        elif opts.startswith("16"):
            end = ">" if "B" in opts else "<"
            kind = "i" if "S" in opts else "u"
            v = _samples(rows, width, 2, end, kind)[:, :width]
        else:
            end = ">" if "B" in opts else "<"
            v = _samples(rows, width, 4, end, "i")[:, :width]
        return v.astype(np.int64)[..., None]
    if name == "F":
        end = ">" if "B" in opts else "<"
        return _samples(rows, width, 4, end, "f")[:, :width, None].astype(
            np.float32)
    if name == "LAB":                # signed a* and b* offset by 128
        return rows[:, :3 * width].reshape(h, width, 3) ^ np.array(
            [0, 128, 128], np.uint8)
    # RGB, RGBA, CMYK families: each sample's (high) byte
    n = len(name)
    if opts.startswith("16"):
        hi = 0 if opts.endswith("B") else 1
        b = rows[:, :2 * n * width].reshape(h, width, n, 2)[..., hi]
    else:
        b = rows[:, :n * width].reshape(h, width, n)
    if name.startswith("RGBa"):
        return np.concatenate([_unpremultiply(b[..., :3], b[..., 3]),
                               b[..., 3:4]], -1)
    keep = 3 if name.startswith("RGBX") or name == "RGB" else 4
    return b[..., :keep]


def to_rgb(px: np.ndarray, mode: str, palette) -> np.ndarray:
    """convert("RGB") of the band values [h, w, bands] in mode."""
    v = px[..., 0]
    if mode in ("1", "L", "LA"):
        g = v.astype(np.uint8)
    elif mode in ("P", "PA"):
        return palette[v.astype(np.uint8)]
    elif mode in ("I;16", "I;16B"):
        g = np.minimum(v, 255).astype(np.uint8)
    elif mode == "I":
        g = np.clip(v, 0, 255).astype(np.uint8)
    elif mode == "F":
        f = np.where(np.isnan(v), 0.0, np.clip(v, 0.0, 255.0))
        g = f.astype(np.uint8)
    elif mode == "CMYK":
        return modes.cmyk_to_rgb(*(px[..., k] for k in range(4)))
    elif mode == "LAB":
        return lcms.lab_to_rgb(px)
    else:
        return np.ascontiguousarray(px[..., :3]).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def _orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """Pillow's exif_transpose of the image by the Orientation tag."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2)
           .transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}
    if orientation in ops:
        rgb = ops[orientation](rgb)
    return np.ascontiguousarray(rgb)


def _list(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> the first image as [H, W, 3] uint8 RGB, row 0 =
    top."""
    prefix, order, tags = _ifd(data)
    if 0xBC01 in tags:
        raise ValueError("TIFF of Windows Media Photo data")
    comp = tags.get(259, 1)
    if comp not in COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} is not a TIFF "
                         f"compression Pillow knows")
    cname = COMPRESSIONS[comp]
    if comp in (34676, 34677):
        photo = tags.get(262, 0)
        raise ValueError(
            f"TIFF with {cname} compression ({comp}) and photometric {photo}:"
            f" Pillow refuses it ("
            + ("its OPEN_INFO has no key for LogL or LogLuv: "
               "UnidentifiedImageError)" if photo in (32844, 32845) else
               "libtiff's SGILog codec takes LogL or LogLuv only)"))
    if comp == 50001:
        raise ValueError("TIFF with WebP compression (50001): Pillow's "
                         "libtiff refuses it (WEBP compression support is "
                         "not configured)")
    if comp not in DECODED:
        raise ValueError(f"TIFF with {cname} compression ({comp}) is not "
                         f"ported (raw, CCITT RLE, Group 3 and 4, LZW, "
                         f"old-style JPEG, JPEG, Deflate, PackBits, "
                         f"ThunderScan, LZMA and ZSTD are)")
    planar = tags.get(284, 1)
    photo = tags.get(262, 0)
    if comp == 6:                 # Pillow: old-style JPEG is YCbCr
        photo = 6
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF without its ImageWidth and ImageLength")
    width, height = tags[256], tags[257]
    if not isinstance(width, int) or not isinstance(height, int):
        raise ValueError("TIFF with an invalid image size")
    fmt_tag = _list(tags.get(339, (1,)))
    if len(fmt_tag) > 1 and max(fmt_tag) == min(fmt_tag) == 1:
        fmt_tag = (1,)
    bits = _list(tags.get(258, (1,)))
    extra = _list(tags.get(338, ()))
    base = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
    n_bands = base + len(extra)
    spp = tags.get(277, 3 if comp == 6 else 1)
    if not isinstance(spp, int) or spp > 6:
        raise ValueError(f"TIFF with {spp} samples a pixel")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError(f"TIFF of {spp} samples with BitsPerSample {bits}")
    key = (prefix, photo, fmt_tag, fill, bits, extra)
    desc = (f"{'x'.join(map(str, bits))}-bit photometric {photo} TIFF "
            f"with {cname} compression")
    if key not in OPEN_INFO:
        if photo == 6:
            raise ValueError(f"{desc}: YCbCr of these samples is not a mode "
                             f"Pillow reads")
        raise ValueError(f"{desc} with sample format {fmt_tag}, fill order "
                         f"{fill} and extra samples {extra}: not a mode "
                         f"Pillow reads")
    mode, raw = OPEN_INFO[key]
    if not width or not height:
        raise ValueError(f"{desc} of {width}x{height} pixels")
    native.check_pixels(desc, width, height)
    palette = None
    if mode in ("P", "PA"):
        if 320 not in tags:
            raise ValueError(f"{desc} without a ColorMap")
        cmap = np.asarray(_list(tags[320]), np.int64) // 256
        k = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(k, 256)] = cmap[:3 * k].reshape(3, k).T[:256]
    px = np.zeros((height, width, BANDS[mode]),
                  {"I": np.int64, "I;16": np.int64, "I;16B": np.int64,
                   "F": np.float32}.get(mode, np.uint8))
    if comp != 1:
        # libtiff reads the header again, by its own rules
        version = struct.unpack_from(order + "H", data, 2)[0]
        if version not in (42, 43) or (version == 43) != (data[2] == 43):
            raise ValueError(f"{desc}: libtiff reads the header's version "
                             f"{version} otherwise than Pillow (not a TIFF "
                             f"to libtiff, or a BigTIFF)")
    if comp == 6:
        return _orient(_read_ojpeg(data, tags, width, height, spp, bits,
                                   desc), tags.get(274))
    if comp == 1:
        _read_raw(data, tags, px, mode, raw, planar, bits, n_bands, desc)
    elif photo == 6 and not (comp == 7 and planar == 1):
        # Pillow reads these through libtiff's TIFFRGBAImage
        rgb = _read_ycbcr(data, tags, height, width, comp, fill, planar,
                          bits, desc)
        return _orient(rgb, tags.get(274))
    else:
        if fill == 2:
            mode, raw = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if comp == 7 and photo == 6:
            raw = "RGB"      # libjpeg converts YCbCr to RGB (JPEGCOLORMODE)
        elif raw == "I;16":
            raw = "I;16N"
        elif raw.endswith((";16B", ";16L")):
            raw = raw[:-1] + "N"
        _read_libtiff(data, tags, px, mode, raw.replace("16N", "16L"),
                      planar, bits, extra, comp, fill, order, desc)
    return _orient(to_rgb(px, mode, palette), tags.get(274))


def _read_raw(data, tags, px, mode, raw, planar, bits, n_bands, desc):
    """Pillow's own reader of uncompressed strips or tiles into px."""
    height, width = px.shape[:2]
    if 273 in tags:
        offsets = _list(tags[273])
        h = tags.get(278, height)
        w = width
    elif 324 in tags:
        offsets = _list(tags[324])
        w, h = tags.get(322), tags.get(323)
        if not isinstance(w, int) or not isinstance(h, int):
            raise ValueError(f"{desc} with invalid tile dimensions")
    else:
        raise ValueError(f"{desc} without strips or tiles")
    if not isinstance(w, int) or not isinstance(h, int) or w <= 0 or h <= 0:
        raise ValueError(f"{desc} with {w}x{h} strips or tiles")
    if w == width and h == height and planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(bits) / 8 if x + w > width else 0
        tile_raw = raw
        if planar == 2:
            if layer >= len(raw):
                raise ValueError(f"{desc}: more planes than bands")
            tile_raw = raw[layer]
            stride /= n_bands
        stride = int(stride)
        x1, y1 = min(x + w, width), min(y + h, height)
        tw, th = x1 - x, y1 - y
        if tw > 0 and th > 0:
            if (mode, tile_raw) in NO_UNPACKER or (
                    planar == 2 and tile_raw == "X"):
                raise ValueError(f"{desc}: Pillow has no unpacker for raw "
                                 f"mode {tile_raw} of mode {mode}")
            layer_band = planar == 2 and px.shape[2] > 1
            nbits = 8 if layer_band else raw_bits(tile_raw)
            row = (tw * nbits + 7) // 8
            if stride and stride < row:
                raise ValueError(f"{desc}: tiles of {stride}-byte rows")
            step = stride or row
            need = step * (th - 1) + row
            chunk = np.frombuffer(data, np.uint8, max(0, min(
                need, len(data) - offset)), offset) if offset < len(
                data) else np.zeros(0, np.uint8)
            if len(chunk) < need:
                raise ValueError(f"{desc}: the image data is truncated")
            rows = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
                chunk, (th, row), (step, 1)))
            if layer_band:
                order = "RGBA" if mode in ("RGB", "RGBA") else mode
                px[y:y1, x:x1, order.index(tile_raw)] = rows[:, :tw]
            else:
                px[y:y1, x:x1] = unpack(rows, tw, tile_raw)
        x += w
        if x >= width:
            x, y = 0, y + h
            if y >= height:
                y = 0
                layer += 1


def _compressed(data, offsets, counts, index, comp, fill, desc):
    """The bytes of strip or tile `index`, bits reversed at FillOrder 2
    (libtiff leaves JPEG's as they are)."""
    if index >= len(offsets) or index >= len(counts):
        raise ValueError(f"{desc}: strip or tile {index} is missing")
    off, n = offsets[index], counts[index]
    if n == 0 or off + n > len(data):
        raise ValueError(f"{desc}: strip or tile {index} of {n} bytes at "
                         f"{off} is past the end of the file")
    raw = np.frombuffer(data, np.uint8, n, off)
    if fill == 2 and comp != 7:
        raw = _REV[raw]
    return raw.tobytes()


def _inflate(raw: bytes, size: int, comp: int, partial: bool) -> bytes:
    """Deflate or LZMA (libtiff's lzma_stream_decoder: .xz only) of raw to
    at most size bytes; with partial, what the stream gave before an error
    (fed a byte at a time, as far as the error)."""
    def new():
        return lzma.LZMADecompressor(lzma.FORMAT_XZ) if comp == 34925 \
            else zlib.decompressobj()

    try:
        return new().decompress(raw, size)
    except (zlib.error, lzma.LZMAError):
        if not partial:
            raise
    d, out = new(), b""
    try:
        for i in range(len(raw)):
            out += d.decompress(raw[i:i + 1], size - len(out))
            if len(out) >= size:
                break
    except (zlib.error, lzma.LZMAError):
        pass
    return out


def _chunk(data, offsets, counts, index, size, comp, fill, desc,
           partial=False):
    """libtiff's TIFFReadEncodedStrip / TIFFReadTile: chunk index decoded
    to size bytes (LZW, PackBits, Deflate, LZMA or ZSTD); an error where
    it fails, or with partial (but ZSTD's) what libtiff decoded before the
    failure, zeros after (the RGBA path goes on with it; what libzstd
    leaves in its output on a failure is its internals', so ZSTD raises)."""
    raw = _compressed(data, offsets, counts, index, comp, fill, desc)
    try:
        if comp == 5:
            return native.tiff_lzw(raw, size, partial)
        if comp == 32773:
            return native.packbits(raw, 0, size, 1, partial)[0]
        if comp == 50000:
            return native.zstd(raw, size)
        out = _inflate(raw, size, comp, partial)
    except (ValueError, zlib.error, lzma.LZMAError) as e:
        raise ValueError(f"{desc}: strip or tile {index}: {e}") from None
    if len(out) < size:
        if partial:
            return np.concatenate([np.frombuffer(out, np.uint8),
                                   np.zeros(size - len(out), np.uint8)])
        raise ValueError(f"{desc}: strip or tile {index} inflates to "
                         f"{len(out)} of its {size} bytes")
    return np.frombuffer(out, np.uint8).copy()


def _jpeg_chunk(data, offsets, counts, index, tables, color, seg_w, seg_h,
                ncomp, sampling, last_strip, desc):
    """libtiff's JPEGPreDecode and JPEGDecode of strip or tile `index`:
    [seg_h, seg_w x components] uint8 (RGB at color 1)."""
    raw = _compressed(data, offsets, counts, index, 7, 1, desc)
    where = f"{desc}: strip or tile {index}"
    try:
        w, h, nc, h0, v0, rest = native.jpeg_tiff_info(tables, raw, color)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    if (h0, v0) != sampling or not rest:
        raise ValueError(f"{where}: improper JPEG sampling factors {h0},"
                         f"{v0} (libtiff wants {sampling[0]},{sampling[1]} "
                         f"and 1,1 after)")
    if w > seg_w or h > seg_h:
        # libtiff lets a last strip's stream run past the image, no more
        if not (w == seg_w and last_strip):
            raise ValueError(f"{where}: a {w}x{h} JPEG exceeds its {seg_w}x"
                             f"{seg_h} strip or tile")
    elif w < seg_w or h < seg_h:
        raise ValueError(f"{where}: a {w}x{h} JPEG in a {seg_w}x{seg_h} "
                         f"strip or tile leaves samples no decoder writes")
    if nc != ncomp:
        raise ValueError(f"{where}: improper JPEG component count {nc}")
    try:
        px = native.jpeg_tiff(tables, raw, color)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    return np.ascontiguousarray(px[:seg_h]).reshape(seg_h, -1)


def _layout(tags, width, height, desc):
    """(chunk width, chunk height, offsets, byte counts) of the strips or
    tiles, as libtiff reads them."""
    if 322 in tags:
        cw, ch = tags[322], tags.get(323)
        offsets, counts = _list(tags.get(324, ())), _list(tags.get(325, ()))
    else:
        cw, ch = width, tags.get(278, height)
        if isinstance(ch, int):
            ch = min(ch, height)
        offsets, counts = _list(tags.get(273, ())), _list(tags.get(279, ()))
    if not isinstance(cw, int) or not isinstance(ch, int) or cw <= 0 \
            or ch <= 0:
        raise ValueError(f"{desc} with {cw}x{ch} strips or tiles")
    native.check_pixels(f"{desc}'s {cw}x{ch} tile", cw, ch)
    return cw, ch, offsets, counts


def _ycbcr_sampling(tags, data, offsets, counts, desc):
    """YCbCrSubsampling of a JPEG-compressed YCbCr image: the tag, or
    where it is missing the first stream's own (libtiff's
    JPEGFixupTagsSubsampling), else libtiff's default 2, 2."""
    if 530 in tags:
        sub = _list(tags[530])
        return (sub[0], sub[1]) if len(sub) >= 2 else (2, 2)
    try:
        raw = _compressed(data, offsets, counts, 0, 7, 1, desc)
        _, _, _, h0, v0, rest = native.jpeg_tiff_info(_tables(tags), raw,
                                                      1)
    except ValueError:
        return 2, 2
    return (h0, v0) if h0 in (1, 2, 4) and v0 in (1, 2, 4) and rest \
        else (2, 2)


def _tables(tags) -> bytes:
    """The JPEGTables tag's bytes (b"" where it is missing)."""
    t = tags.get(347, b"")
    return t if isinstance(t, bytes) else bytes(_list(t))


# libtiff's putcontig8bitYCbCr*tile: the subsamplings (horizontal,
# vertical) it has a put function for (in planes, 1x1 only)
YCBCR_CONTIG = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}


def _ycbcr_tables(luma, rbw):
    """tif_color.c TIFFYCbCrToRGBInit (8-bit, float32 arithmetic as C
    does it): Y, Cr->R, Cb->B, Cr->G and Cb->G tables, int64 [256]."""
    f = np.float32

    def fix(x):                  # FIX(): float x * 65536, + 0.5 in double
        return int(float(f(x) * f(65536)) + 0.5)

    def clamp(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    def code2v(c, rb, rw, cr):
        den = rw - rb
        return f(f(c - int(rb)) * f(cr)) / (den if den != 0 else f(1))

    lr, lg, lb = (f(v) for v in luma)
    f1 = f(2) - f(2) * lr
    d1 = fix(clamp(f1, f(0), f(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clamp(f2, f(0), f(2)))
    f3 = f(2) - f(2) * lb
    d3 = fix(clamp(f3, f(0), f(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clamp(f4, f(0), f(2)))
    lo, hi = f(-128 * 32), f(128 * 32)
    rb = [f(v) for v in rbw]
    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, rb[4] - f(128), rb[5] - f(128), 127), lo, hi))
        cb = int(clamp(code2v(x, rb[2] - f(128), rb[3] - f(128), 127), lo, hi))
        tabs[1, i] = (d1 * cr + 32768) >> 16
        tabs[2, i] = (d3 * cb + 32768) >> 16
        tabs[3, i] = d2 * cr
        tabs[4, i] = d4 * cb + 32768
        tabs[0, i] = int(clamp(code2v(x + 128, rb[0], rb[1], 255), lo, hi))
    return tabs


def _ycbcr_conversion(tags, desc):
    """TIFFYCbCrToRGBInit's tables of the YCbCrCoefficients and
    ReferenceBlackWhite tags (their defaults where missing), with libtiff's
    checks of them."""
    luma = _list(tags.get(529, ()))
    rbw = _list(tags.get(532, ()))
    luma = luma if len(luma) == 3 else (0.299, 0.587, 0.114)
    rbw = rbw if len(rbw) == 6 else (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
    f32 = np.float32
    if any(np.isnan(v) for v in luma) or f32(luma[1]) == 0:
        raise ValueError(f"{desc}: invalid YCbCrCoefficients {luma}")
    if not all(f32(-0x7FFFFFFF + 128) < f32(v) < f32(0x7FFFFFFF)
               for v in rbw):
        raise ValueError(f"{desc}: invalid ReferenceBlackWhite {rbw}")
    return _ycbcr_tables(luma, rbw)


def _read_ojpeg(data, tags, width, height, spp, bits, desc) -> np.ndarray:
    """Old-style JPEG (ojpeg.py) -> [H, W, 3] uint8: grey as libjpeg gives
    it through TIFFReadEncodedStrip, YCbCr (libtiff takes photometric RGB
    or a missing one for it) through the RGBA path, chroma held over each
    block of the frame's sampling."""
    file_photo = tags.get(262)
    ycbcr = file_photo in (None, 2, 6)
    if bits != (8,) * spp or spp != (3 if ycbcr else 1):
        raise ValueError(f"{desc}: old-style JPEG of photometric "
                         f"{file_photo} and {spp} samples is not ported "
                         f"(grey: 1 sample; YCbCr or RGB: 3)")
    if not ycbcr:
        grey = ojpeg.decode(data, tags, width, height, 1, False, desc)
        return np.repeat(grey[..., None], 3, axis=2)
    tabs = _ycbcr_conversion(tags, desc)
    y, cb, cr, (hs, vs) = ojpeg.decode(data, tags, width, height, 3, True,
                                       desc)
    if (hs, vs) not in YCBCR_CONTIG:
        raise ValueError(f"{desc}: libtiff has no RGBA conversion of YCbCr "
                         f"subsampled {hs},{vs}")
    up = [np.repeat(np.repeat(c, vs, 0), hs, 1)[:height, :width]
          for c in (cb, cr)]
    return _ycbcr_to_rgb(tabs, y, *up)


def _ycbcr_to_rgb(tabs, y, cb, cr) -> np.ndarray:
    """TIFFYCbCrtoRGB of uint8 arrays -> [..., 3] uint8."""
    yv = tabs[0][y]
    r = yv + tabs[1][cr]
    g = yv + ((tabs[4][cb] + tabs[3][cr]) >> 16)
    b = yv + tabs[2][cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _read_ycbcr(data, tags, height, width, comp, fill, planar, bits,
                desc) -> np.ndarray:
    """Pillow's _decodeAsRGBA: libtiff's TIFFRGBAImageGet of YCbCr in
    blocks of a strip's or a tile row's rows, converted by TIFFYCbCrtoRGB
    with chroma held over each subsampling block -> [H, W, 3] uint8 (the
    Orientation tag is left to Pillow's exif_transpose).

    Pillow asks libtiff not to stop on a chunk's errors, and what libtiff
    then hands over is followed: a chunk that fails to decode gives what
    was decoded before the failure, zeros after (_chunk's partial); a
    predictor that refuses the rows leaves them as decoded; a strip read
    short by libtiff's truncated scanline size (4x4 subsampling, an odd
    count of blocks across) reads zeros past it, from a buffer each block
    of rows allocates zeroed; putcontig8bitYCbCr44tile skips a cut tile's
    blocks at 10 bytes each."""
    if bits != (8, 8, 8):
        raise ValueError(f"{desc}: libtiff's RGBA path converts 8-bit YCbCr "
                         f"only")
    sub = _list(tags.get(530, (2, 2)))
    hs, vs = (sub[0], sub[1]) if len(sub) >= 2 else (2, 2)
    if hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError(f"{desc}: invalid YCbCr subsampling {hs},{vs}")
    if (hs, vs) not in (YCBCR_CONTIG if planar == 1 else {(1, 1)}):
        raise ValueError(f"{desc}: libtiff has no RGBA conversion of "
                         f"YCbCr subsampled {hs},{vs} "
                         f"({'contiguous' if planar == 1 else 'planar'})")
    tabs = _ycbcr_conversion(tags, desc)
    predictor = tags.get(317, 1) if comp in PREDICTED else 1
    if predictor not in (1, 2):
        raise ValueError(f"{desc}: Predictor {predictor} on YCbCr")
    cw, ch, offsets, counts = _layout(tags, width, height, desc)
    tiled = 322 in tags
    unit = hs * vs + 2
    blocks = -(-cw // hs)
    line = blocks * unit // vs if planar == 1 else cw  # libtiff's scanline
    # the predictor's rows: the scanline, or a tile's unsubsampled row
    pred_line = cw * (3 if planar == 1 else 1) if tiled else line
    out = np.zeros((height, width, 3), np.uint8)
    across = -(-width // cw)
    down = -(-height // ch)
    for ty in range(down):
        y0 = ty * ch
        nrow = min(ch, height - y0)
        brows = -(-nrow // vs)
        for tx in range(across):
            x0 = tx * cw
            tw = min(cw, width - x0)
            if planar == 1:
                held = -(-(ch if tiled else nrow) // vs) * blocks * unit
                size = held if tiled else min(brows * vs * line, held)
                buf = _chunk(data, offsets, counts, ty * across + tx, size,
                             comp, fill, desc, partial=True)
                _predict_rows(buf, pred_line, predictor)
                if size < held:              # the rest of a zeroed buffer
                    buf = np.concatenate([buf, np.zeros(held - size,
                                                        np.uint8)])
                stride = blocks * unit
                if (hs, vs) == (4, 4) and tw < cw:
                    stride = unit * -(-tw // 4) + (cw - tw) // 4 * 10
                units = np.stack([buf[r * stride:r * stride + -(-tw // hs)
                                      * unit] for r in range(brows)]) \
                    .reshape(brows, -1, unit)
                nb = units.shape[1]
                yy = units[..., :hs * vs].reshape(brows, nb, vs, hs) \
                    .transpose(0, 2, 1, 3).reshape(brows * vs, nb * hs)
                cb = np.repeat(np.repeat(units[..., hs * vs], hs, 1), vs, 0)
                cr = np.repeat(np.repeat(units[..., hs * vs + 1], hs, 1), vs,
                               0)
                rgb = _ycbcr_to_rgb(tabs, yy[:nrow, :tw], cb[:nrow, :tw],
                                    cr[:nrow, :tw])
            else:
                planes = []
                for k in range(3):
                    index = k * across * down + ty * across + tx
                    rows = ch if tiled else nrow
                    if comp == 7:         # a one-component JPEG a plane
                        buf = _jpeg_chunk(
                            data, offsets, counts, index, _tables(tags), 0,
                            cw, rows, 1, (1, 1),
                            not tiled and y0 + rows >= height, desc)
                        planes.append(buf[:nrow, :tw])
                        continue
                    buf = _chunk(data, offsets, counts, index, rows * line,
                                 comp, fill, desc, partial=True)
                    _predict_rows(buf, pred_line, predictor, stride=1)
                    planes.append(buf.reshape(rows, line)[:nrow, :tw])
                rgb = _ycbcr_to_rgb(tabs, *planes)
            out[y0:y0 + nrow, x0:x0 + tw] = rgb
    return out


def _predict_rows(buf, line, predictor, stride=3):
    """libtiff's PredictorDecodeTile over rows of `line` bytes (its
    scanline size), samples `stride` apart, in place; rows it refuses
    (not a whole count of rows, or of samples in a row) it leaves as they
    are, as the RGBA path goes on with them."""
    if predictor == 1 or len(buf) % line or line % stride:
        return
    native.tiff_predict(buf.reshape(-1, line), len(buf) // line, 8, stride,
                        2, False)


def _read_libtiff(data, tags, px, mode, raw, planar, bits, extra, comp,
                  fill, order, desc):
    """Pillow's libtiff reader: strips or tiles decoded whole, predictor
    undone, then unpacked (one plane a band where planar)."""
    height, width = px.shape[:2]
    bps = bits[0]
    if any(b != bps for b in bits):
        raise ValueError(f"{desc}: libtiff takes one BitsPerSample")
    spp = len(bits)
    bands = px.shape[2]
    planes = bands if planar == 2 and bands > 1 else 1
    if planes > 1 and bps not in (8, 16):
        raise ValueError(f"{desc}: Pillow reads separate planes at 8 or 16 "
                         f"bits only")
    samples = 1 if planar == 2 else spp
    predictor = tags.get(317, 1) if comp in PREDICTED else 1
    if predictor not in (1, 2, 3):
        raise ValueError(f"{desc}: Predictor {predictor} is not one libtiff "
                         f"knows")
    if predictor == 3 and tags.get(339, (1,)) not in (3, (3,) * spp, (3,)):
        raise ValueError(f"{desc}: floating point Predictor on integer "
                         f"samples")
    cw, ch, offsets, counts = _layout(tags, width, height, desc)
    row_bytes = (cw * bps * samples + 7) // 8
    # Pillow's check of libtiff's strip rows against its unpacker's (a tile
    # whose rows are shorter than the unpacker reads, Pillow reads past)
    if (322 not in tags or planes == 1) and \
            (cw * raw_bits(raw) // planes + 7) // 8 > row_bytes:
        raise ValueError(f"{desc}: libtiff's rows are shorter than raw mode "
                         f"{raw} reads")
    across = -(-width // cw)
    down = -(-height // ch)
    tiled = 322 in tags

    def rows_of(ty):
        return ch if tiled else min(ch, height - ty * ch)

    if comp == 32809:
        if bps != 4:
            raise ValueError(f"{desc}: Wrong bitspersample value ({bps}), "
                             f"libtiff's Thunder decoder only supports 4 "
                             f"bits per sample")
        if tiled or spp != 1:
            raise ValueError(f"{desc}: ThunderScan in tiles or of {spp} "
                             f"samples a pixel is not ported (libtiff decodes "
                             f"an image width a row there)")
    if comp in FAX:
        if bps != 1 or spp != 1:
            raise ValueError(f"{desc}: libtiff's CCITT decoders take 1-bit "
                             f"samples only")
        n = across * down
        chunks = [_compressed(data, offsets, counts, i, comp, fill, desc)
                  for i in range(n)]
        try:
            fax = native.fax(chunks, comp, _list(tags.get(292, 0))[0], cw,
                             [rows_of(i // across) for i in range(n)])
        except ValueError as e:
            raise ValueError(f"{desc}: {e}") from None
        starts = np.cumsum([0] + [rows_of(i // across) for i in range(n)])
    if comp == 7:
        if bps != 8:
            raise ValueError(f"{desc}: libjpeg in libtiff takes 8-bit "
                             f"samples only")
        sampling = (1, 1)
        if tags.get(262, 0) == 6:
            sampling = _ycbcr_sampling(tags, data, offsets, counts, desc)
        tables = _tables(tags)
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = rows_of(ty)
                index = plane * across * down + ty * across + tx
                if comp in FAX:
                    buf = fax[starts[index]:starts[index + 1]]
                elif comp == 32809:
                    coded = _compressed(data, offsets, counts, index, comp,
                                        fill, desc)
                    try:
                        buf = native.thunder(coded, cw, rows)
                    except ValueError as e:
                        raise ValueError(f"{desc}: strip {index}: {e}") \
                            from None
                elif comp == 7:
                    buf = _jpeg_chunk(
                        data, offsets, counts, index, tables,
                        1 if tags.get(262, 0) == 6 else 0, cw, rows,
                        samples, sampling if planes == 1 else (1, 1),
                        not tiled and y0 + rows >= height, desc)
                else:
                    buf = _chunk(data, offsets, counts, index,
                                 rows * row_bytes, comp, fill, desc
                                 ).reshape(rows, row_bytes)
                if predictor > 1:
                    try:
                        native.tiff_predict(buf, rows, bps, samples,
                                            predictor, order == ">")
                    except ValueError as e:
                        raise ValueError(f"{desc}: {e}") from None
                elif bps in (16, 32, 64) and order == ">":
                    buf = buf.reshape(rows, -1, bps // 8)[..., ::-1] \
                        .reshape(rows, row_bytes)
                y1, x1 = min(y0 + ch, height), min(x0 + cw, width)
                part = buf[:y1 - y0]
                if planes == 1:
                    px[y0:y1, x0:x1] = unpack(np.ascontiguousarray(part),
                                              x1 - x0, raw)
                else:
                    step = bps // 8
                    px[y0:y1, x0:x1, plane] = part[:, step - 1:step * (
                        x1 - x0):step]
    # libtiff's first extra sample: unspecified where the tag is missing,
    # unassociated for Corel's 999
    first_extra = (extra or (0,))[0]
    if planes > 3 and mode == "RGBA" and first_extra in (0, 1):
        px[..., :3] = _unpremultiply(px[..., :3], px[..., 3])
