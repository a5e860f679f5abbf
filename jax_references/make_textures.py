"""Makes the texture fixtures of the port's image decoders
(tests/torch_textures/): small files of every kind that the port's
`load_image` reads (PNG at every bit depth and colour type, plain and
Adam7 interlaced; BMP of every depth, header and compression it reads;
baseline and progressive JPEG in grey, 4:4:4, 4:2:2 and 4:2:0, with and
without restart intervals, JFIF YCbCr and Adobe RGB / YCbCr; TGA of every
image type, depth and orientation, raw and run-length; P1 to P6 PNM with
comments, odd maxvals and 16-bit samples; GIF with global and local
tables, interlaced, offset and transparent frames; PSD raw and PackBits in
every colour mode Pillow converts), and one 1024x1024 progressive 4:2:0
JPEG at quality 90, all from seeded numpy images; and the JPEG variants
Pillow opens but does not write (every whole sampling, CMYK and YCCK,
arithmetic coding, scans that leave coefficients unrefined, lossless);
JPEG 2000 codestreams and JP2 files (Pillow's saves, OpenJPEG's own
encoder through ctypes in j2k_encoder.py for what Pillow's save cannot
set, JP2 boxes and PPT / PPM headers rewritten by hand) and ICNS icons;
and, in tests/torch_textures/j2k_chip/ with a manifest of its own, the
1024x1024 JPEG's texels as a lossless J2K crop, a lossy JP2 and an ICNS
of it for chip_smoke.py phase 18c.
It is the JAX side: Pillow writes the JPEGs and some TGA, PNM and GIF
files, Pillow's own libjpeg-turbo compressor (jpeg_encoder.py) the JPEG
variants, the encoders below the rest (PNGs with the port's row
filters), and the JAX
package's `cge_tpu.scene.image_io.load_image` (Pillow's
`convert("RGB")`) gives the reference pixels.

manifest.json records each file's kind, format, shape and the SHA-256 of
JAX's pixels quantised to u8 ([H, W, 3] C order), with the Pillow and
libjpeg-turbo versions, the commit and the command. The port's tests hold
its decoders to JAX's pixels on every file; chip_smoke.py holds them to
the manifest's hashes on the card's machine, which has no Pillow.
tests/torch_textures/legacy/ holds the GIMP brushes, FLI / FLC, Windows
Paint, Kodak PhotoCD, PIXAR and XV thumbnail files of legacy_fixtures,
those JAX's loader refuses listed with its error's name; `--legacy` writes
that folder alone.

    JAX_PLATFORMS=cpu python3 jax_references/make_textures.py [--legacy]
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import lzma
import os
import struct
import subprocess
import sys
import warnings
import zlib

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402
from PIL import features  # noqa: E402

from cge_tpu_torch.scene.image_io import _chunk, _filter_rows  # noqa: E402
from jax_references.j2k_encoder import STYLE, j2k_encode  # noqa: E402
from jax_references.jpeg_encoder import jpeg_encode  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_textures")
MANIFEST = os.path.join(OUT, "manifest.json")
BIG = "jpeg_progressive_420_q90_1024.jpg"
# BIG's texels as a tiled JPEG-in-TIFF, YCbCr 2x2 at quality 85
TIFF_JPEG_BIG = "tiff_jpeg_ycbcr22_tiles_q85_1024.tif"
# BIG's texels as lossy WebP, and their top-left corner as lossless WebP
WEBP_BIG = "webp_lossy_q90_1024.webp"
WEBP_CROP = 256
WEBP_CROP_NAME = f"webp_lossless_crop{WEBP_CROP}.webp"
COMMAND = "JAX_PLATFORMS=cpu python3 jax_references/make_textures.py"

# ---------------------------------------------------------------- PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] -> scanline bytes [h, stride] (no filter byte)."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint32)], axis=1)
    groups = flat.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1, dtype=np.uint32)
    return (groups << shifts).sum(-1).astype(np.uint8)


def png_file(samples: np.ndarray, depth: int, ctype: int,
             interlace: bool = False, palette=None, trns: bytes = b"",
             filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of any bit depth and colour type: samples [h, w, ch] integers
    (palette indices for colour type 3, with palette [K, 3]), plain or
    Adam7, rows filtered in turn by `filters`, with an optional tRNS."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    assert ch == _CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)
    if interlace:
        body = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                body += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    else:
        body = _filter_rows(_pack_rows(samples, depth), bpp, filters)
    parts = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns:
        parts.append(_chunk(b"tRNS", trns))
    body = zlib.compress(body, 9)
    parts += [_chunk(b"IDAT", body[:len(body) // 2]),
              _chunk(b"IDAT", body[len(body) // 2:]), _chunk(b"IEND", b"")]
    return b"".join(parts)


# ---------------------------------------------------------------- BMP

def _rows(data_rows, row_bytes: int) -> bytes:
    stride = (row_bytes + 3) & ~3
    return b"".join(bytes(r) + bytes(stride - len(bytes(r)))
                    for r in data_rows)


def bmp_file(width: int, height: int, bits: int, pixel_data: bytes,
             compression: int = 0, header: int = 40, masks=None,
             palette=None, top_down: bool = False) -> bytes:
    """A BMP around its pixel data (rows in file order): header of 12,
    40, 108 or 124 bytes; masks after a 40-byte header or inside a
    larger one; palette [K, 3] RGB written as BGR(X)."""
    pal = b""
    if palette is not None:
        pad = b"" if header == 12 else b"\x00"
        pal = b"".join(bytes((int(c[2]), int(c[1]), int(c[0]))) + pad
                       for c in palette)
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixel_data), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        m = tuple(masks or (0, 0, 0)) + (0,)
        if header == 40:
            extra = struct.pack("<III", *m[:3]) if masks else b""
        else:
            info += struct.pack("<IIII", *m[:4]) + bytes(header - 56)
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixel_data), 0, 0,
                                offset) + info + extra + pal + pixel_data)


def rle_stream(idx: np.ndarray, rle4: bool, rng) -> bytes:
    """Palette indices [h, w] (bottom row first) as an RLE8 / RLE4 stream
    of encoded runs, absolute runs and end-of-line codes, ended by end of
    bitmap; absolute runs are padded to an even length, as the format
    asks (even runs only under RLE4, which Pillow reads whole)."""
    out = bytearray()
    for row in idx:
        x, w = 0, len(row)
        while x < w:
            n = int(min(w - x, rng.integers(1, 9)))
            run = row[x:x + n]
            if rng.random() < 0.5 or n < 3 or (rle4 and n % 2):
                # an encoded run of the first index (RLE4: of the first two
                # in turn)
                second = int(run[1]) if rle4 and n > 1 else 0
                out += bytes((n, (int(run[0]) << 4 | second) if rle4
                              else int(run[0])))
            else:
                out += bytes((0, n))
                if rle4:
                    body = bytes((int(run[i]) << 4) | int(run[i + 1])
                                 for i in range(0, n, 2))
                else:
                    body = bytes(int(v) for v in run)
                out += body + bytes(len(body) % 2)
            x += n
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


# ---------------------------------------------------------------- TGA

def tga_file(width: int, height: int, itype: int, depth: int,
             pixel_data: bytes, colour_map: bytes = b"", map_start: int = 0,
             map_depth: int = 0, descriptor: int = 0,
             image_id: bytes = b"") -> bytes:
    """A TGA around its pixel data (rows in file order) and colour map
    (entries of map_depth bits from index map_start)."""
    entries = len(colour_map) // (map_depth // 8) if colour_map else 0
    return struct.pack("<BBBHHBHHHHBB", len(image_id), int(bool(colour_map)),
                       itype, map_start, entries, map_depth, 0, 0, width,
                       height, depth, descriptor) + image_id + colour_map + \
        pixel_data


def tga_rle_rows(px: np.ndarray, rng) -> bytes:
    """[h, w, bytes] as run-length packets: runs of one pixel value within
    a row, literal packets that run on across the row ends."""
    h, w, b = px.shape
    out = bytearray()
    lit = []
    for row in px:
        x = 0
        while x < w:
            k = 1
            while x + k < w and k < 128 and (row[x + k] == row[x]).all():
                k += 1
            if k >= 2 and rng.random() < 0.8:
                for j in range(0, len(lit), 128):
                    chunk = lit[j:j + 128]
                    out += bytes((len(chunk) - 1,)) + b"".join(chunk)
                lit = []
                out += bytes((0x80 | (k - 1),)) + row[x].tobytes()
            else:
                lit += [row[x + j].tobytes() for j in range(k)]
            x += k
    for j in range(0, len(lit), 128):
        chunk = lit[j:j + 128]
        out += bytes((len(chunk) - 1,)) + b"".join(chunk)
    return bytes(out)


# ---------------------------------------------------------------- GIF

def lzw_codes(indices, min_size: int, clear_every: int = 0) -> bytes:
    """GIF LZW code stream of palette indices (variable-width codes, a
    clear code first and every `clear_every` codes, the end code last),
    not yet cut into sub-blocks."""
    clear = 1 << min_size

    def fresh():
        return {bytes((i,)): i for i in range(clear)}, clear + 2, min_size + 1

    table, nxt, width = fresh()
    codes = [(clear, width)]
    cur, emitted = b"", 0
    for v in indices:
        c = cur + bytes((int(v),))
        if c in table:
            cur = c
            continue
        codes.append((table[cur], width))
        emitted += 1
        if nxt < 4096:
            table[c] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        if clear_every and emitted % clear_every == 0:
            codes.append((clear, width))
            table, nxt, width = fresh()
        cur = bytes((int(v),))
    if cur:
        codes.append((table[cur], width))
    codes.append((clear + 1, width))
    acc = nbits = 0
    out = bytearray()
    for code, w in codes:
        acc |= code << nbits
        nbits += w
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    return bytes(out)


def _table(colours) -> tuple[int, bytes]:
    """A GIF colour table's size field and bytes (padded with black)."""
    colours = np.asarray(colours, np.uint8).reshape(-1, 3)
    bits = max(1, (len(colours) - 1).bit_length())
    return bits - 1, colours.tobytes() + bytes(3 * ((1 << bits) - len(
        colours)))


def gif_file(screen, frame: np.ndarray, global_table=None, local_table=None,
             offset=(0, 0), transparent=None, interlace: bool = False,
             min_size: int = 0, clear_every: int = 0,
             extensions: bytes = b"") -> bytes:
    """A one-frame GIF89a: a screen of (width, height), the frame's indices
    [h, w] at `offset`, global and local tables [K, 3], a graphic control
    extension with the transparent index, the rows interlaced or not."""
    flags, gtab = 0, b""
    if global_table is not None:
        size, gtab = _table(global_table)
        flags = 0x80 | size
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0) + gtab
    out += extensions
    if transparent is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparent) + b"\0"
    h, w = frame.shape
    iflags, ltab = 0x40 if interlace else 0, b""
    if local_table is not None:
        size, ltab = _table(local_table)
        iflags |= 0x80 | size
    out += b"," + struct.pack("<HHHHB", *offset, w, h, iflags) + ltab
    rows = ([y for y0, dy in ((0, 8), (4, 8), (2, 4), (1, 2))
             for y in range(y0, h, dy)] if interlace else range(h))
    min_size = min_size or max(2, int(frame.max()).bit_length())
    codes = lzw_codes(np.concatenate([frame[y] for y in rows]), min_size,
                      clear_every)
    blocks = b"".join(bytes((len(codes[i:i + 255]),)) + codes[i:i + 255]
                      for i in range(0, len(codes), 255))
    return out + bytes((min_size,)) + blocks + b"\0;"


# ---------------------------------------------------------------- PSD

def packbits_rows(plane: np.ndarray, rng) -> list:
    """Each row of a plane [h, row_bytes] as PackBits packets (runs of a
    repeated byte, literals, the odd no-op 0x80)."""
    rows = []
    for row in plane:
        out, x, n = bytearray(), 0, len(row)
        while x < n:
            k = 1
            while x + k < n and k < 128 and row[x + k] == row[x]:
                k += 1
            if k >= 2:
                out += bytes((257 - k, int(row[x])))
            else:
                k = int(min(n - x, rng.integers(1, 6)))
                out += bytes((k - 1,)) + row[x:x + k].tobytes()
            if rng.random() < 0.05:
                out += b"\x80"
            x += k
        rows.append(bytes(out))
    return rows


def psd_file(width: int, height: int, mode: int, depth: int,
             planes: list, rle: bool = False, rng=None,
             colour_data: bytes = b"", channels: int = 0,
             resources: bytes = b"", layers: bytes = b"") -> bytes:
    """A PSD of version 1: planes [h, row_bytes] one a channel, raw or
    PackBits (each row's byte count in the table before the data)."""
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or len(planes),
                                height, width, depth, mode)
    for section in (colour_data, resources, layers):
        out += struct.pack(">I", len(section)) + section
    if not rle:
        return out + b"\0\0" + b"".join(p.tobytes() for p in planes)
    rows = [packbits_rows(p, rng) for p in planes]
    counts = b"".join(struct.pack(">H", len(r)) for ch in rows for r in ch)
    return out + b"\0\1" + counts + b"".join(r for ch in rows for r in ch)


# ---------------------------------------------------------------- TIFF

_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q", 5: "I", 7: "B"}


def tiff_lzw(data: bytes, lsb: bool = False) -> bytes:
    """TIFF LZW codes of data: MSB-first with the early code-width change,
    or the old LSB-first codes (the width changes one code later)."""
    out = bytearray()
    acc = nbits = 0

    def put(code, width):
        nonlocal acc, nbits
        if lsb:
            acc |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << width) | code
            nbits += width
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 0xFF)
                nbits -= 8
                acc &= (1 << nbits) - 1

    late = 1 if lsb else 0      # the decoder's table lags by one code
    table = {bytes((i,)): i for i in range(256)}
    nxt, width = 258, 9
    put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes((byte,))
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            put(256, width)
            table = {bytes((i,)): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt == (1 << width) + late:
            width += 1
        w = bytes((byte,))
    if w:
        put(table[w], width)
        nxt += 1
        if nxt == (1 << width) + late and width < 12:
            width += 1
    put(257, width)
    if nbits:
        put(0, 8 - nbits)
    return bytes(out)


def tiff_packbits(data: bytes) -> bytes:
    """PackBits of data: runs of 3 or more as run packets, else literals."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes((257 - (j - i), data[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def _pack_samples(values: np.ndarray, bits: int, order: str) -> bytes:
    """One row of samples -> bytes: MSB-first bit packing below 8 bits,
    else bits / 8 bytes each in the file's byte order."""
    if bits < 8:
        v = values.astype(np.uint8)
        bitrow = ((v[:, None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(-1)
        return np.packbits(bitrow).tobytes()
    if bits == 12:
        v = values.astype(np.uint32)
        bitrow = ((v[:, None] >> np.arange(11, -1, -1)) & 1).reshape(-1)
        return np.packbits(bitrow.astype(np.uint8)).tobytes()
    dt = {8: "u1", 16: "u2", 32: "u4", 64: "u8"}[bits]
    if values.dtype.kind == "f":
        dt = {32: "f4", 64: "f8"}[bits]
    elif values.dtype.kind == "i":
        dt = dt.replace("u", "i")
    return values.astype(order + dt).tobytes()


def _predict2(values: np.ndarray, bits: int, stride: int) -> np.ndarray:
    """Horizontal differencing of a row of samples, stride samples apart."""
    v = values.astype(np.int64)
    out = v.copy()
    out[stride:] = v[stride:] - v[:-stride]
    return out & ((1 << bits) - 1)


def _predict3(row_bytes_native: bytes, bps: int, stride: int) -> bytes:
    """libtiff's fpDiff of a row of little-endian floats."""
    b = np.frombuffer(row_bytes_native, np.uint8)
    wc = len(b) // bps
    planes = b.reshape(wc, bps)[:, ::-1].T.reshape(-1).astype(np.int64)
    out = planes.copy()
    out[stride:] = planes[stride:] - planes[:-stride]
    return (out & 0xFF).astype(np.uint8).tobytes()


def compress_chunk(raw: bytes, compression: int, level=None) -> bytes:
    """One strip's or tile's bytes as TIFF compression `compression` (1
    raw, 5 LZW, 8 / 32946 Deflate, 32773 PackBits, 34925 LZMA in an .xz
    stream as libtiff writes it, 50000 ZSTD at `level`, 3 by default)."""
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return tiff_packbits(raw)
    if compression == 34925:
        return lzma.compress(raw, lzma.FORMAT_XZ, lzma.CHECK_NONE)
    if compression == 50000:
        import zstandard

        return zstandard.ZstdCompressor(level=level or 3).compress(raw)
    return raw


def thunder_row(row, rng) -> bytes:
    """A ThunderScan row (TIFF compression 32809) of 4-bit pixels: runs of
    the last pixel, three 2-bit or two 3-bit deltas (with skip codes where
    fewer fit), and raw pixels, each where it applies and rng picks it."""
    out, last, i, w = bytearray(), 0, 0, len(row)
    d2 = {0: 0, 1: 1, 15: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}

    def deltas(table, most):
        codes, prev, j = [], last, i
        while j < w and len(codes) < most and (int(row[j]) - prev) % 16 \
                in table:
            codes.append(table[(int(row[j]) - prev) % 16])
            prev = int(row[j])
            j += 1
        return codes, prev, j

    while i < w:
        k = 0
        while i + k < w and row[i + k] == last and k < 63:
            k += 1
        if k and rng.random() < 0.7:
            out.append(k)
            i += k
            continue
        codes, prev, j = deltas(d2, 3)
        if len(codes) >= 2 and rng.random() < 0.8:
            codes += [2] * (3 - len(codes))
            out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
            last, i = prev, j
            continue
        codes, prev, j = deltas(d3, 2)
        if codes and rng.random() < 0.8:
            codes += [4] * (2 - len(codes))
            out.append(0x80 | codes[0] << 3 | codes[1])
            last, i = prev, j
            continue
        out.append(0xC0 | int(row[i]))
        last, i = int(row[i]), i + 1
    return bytes(out)


def thunder_tiles(px: np.ndarray, tile, rng) -> list:
    """ThunderScan tiles of 4-bit pixels px [h, w]: each (edge-padded)
    tile's rows coded by thunder_row."""
    h, w = px.shape
    tw, th = tile
    return [b"".join(thunder_row(r, rng) for r in np.pad(
        px[ty:ty + th, tx:tx + tw],
        ((0, max(0, ty + th - h)), (0, max(0, tx + tw - w))), mode="edge"))
        for ty in range(0, h, th) for tx in range(0, w, tw)]


def _scan_parts(jpeg: bytes) -> tuple:
    """A JPEG -> (its bytes to the end of the first SOS; each scan as
    (the marker segments before it, through its SOS, b"" for the first;
    its entropy-coded data, EOI kept at the end of the last))."""
    sos = jpeg.index(b"\xff\xda")
    head_end = sos + 2 + struct.unpack_from(">H", jpeg, sos + 2)[0]
    scans, prefix, pos = [], b"", head_end
    while True:
        start = pos
        while not (jpeg[pos] == 0xFF and jpeg[pos + 1] not in (
                0x00, 0xD0, 0xD1, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7)):
            pos += 1
        if jpeg[pos + 1] == 0xD9:
            scans.append((prefix, jpeg[start:]))
            return jpeg[:head_end], scans
        scans.append((prefix, jpeg[start:pos]))
        seg_start = pos
        while jpeg[pos + 1] != 0xDA:
            pos += 2 + struct.unpack_from(">H", jpeg, pos + 2)[0]
        pos += 2 + struct.unpack_from(">H", jpeg, pos + 2)[0]
        prefix = jpeg[seg_start:pos]


def ojpeg_tiff(img: np.ndarray, photometric: int, *, form: str = "stream",
               rows_per_strip=None, subsampling: int = 0, quality: int = 80,
               restart: int = 0, order: str = "<", extra_tags=(),
               jif_length: bool = True, tile=None, planar: int = 1,
               sampling=None, subsampling_tag=None) -> bytes:
    """An old-style JPEG TIFF (compression 6) of img [h, w, k] u8: one
    baseline JPEG of the whole image that Pillow's writer makes (grey at
    photometric 0 or 1, else JFIF YCbCr at subsampling 0, 1 or 2 for 1x1,
    2x1 and 2x2, YCbCrSubsampling to match), with a restart marker after
    each strip's MCU rows where there are several strips (or every restart
    MCUs), laid out as libtiff's OJPEG codec reads it:
      "stream"  the strips hold the stream: the first from SOI, each after
                the restart marker that ends the one before it;
      "jif"     JPEGInterchangeFormat (and, with jif_length, its Length)
                the stream's header (SOI to the end of SOS), the strips its
                scan data between the strips' restart markers;
      "tables"  JPEGProc 1, JPEGQTables, JPEGDCTables and JPEGACTables (and
                JPEGRestartInterval with restart) from the stream's tables,
                the strips its scan data.
    The restart markers between strips are left out (libtiff puts them
    back); those inside a strip stay.
    tile (width, height): tiles, the stream's frame one tile wide and the
    tiles (edge-padded) one under another in the order libtiff reads
    them, a restart marker after each. planar 2: separate planes, the
    JPEG one scan a component (libjpeg-turbo's compressor), each plane's
    strips from its scan, the first after the marker segments and SOS
    that start it (restart markers a strip's blocks apart, 1x1 sampling
    for several strips). sampling: the components' (h, v) factors through
    libjpeg-turbo's compressor (YCbCr, or grey); subsampling_tag: the
    YCbCrSubsampling tag's (h, v) in place of the frame's, or () for
    none."""
    h, w, k = img.shape
    grey = photometric in (0, 1)
    if sampling is not None:
        hs, vs = sampling[0]
    else:
        hs, vs = (1, 1) if grey else {0: (1, 1), 1: (2, 1), 2: (2, 2)}[
            subsampling]
    src, rps = img, rows_per_strip or h
    if tile:
        tw, rps = tile
        src = np.concatenate([
            np.pad(img[ty:ty + rps, tx:tx + tw],
                   ((0, max(0, ty + rps - h)), (0, max(0, tx + tw - w)),
                    (0, 0)), mode="edge")
            for ty in range(0, h, rps) for tx in range(0, w, tw)])
    split = rps < src.shape[0]
    if split and restart:
        raise ValueError("restart is for a single strip")
    if planar == 2 or sampling is not None:
        kw = dict(quality=quality, colorspace="grey" if grey else "ycc")
        if sampling is not None:
            kw["sampling"] = sampling
        if planar == 2:
            kw["scans"] = [((c,), 0, 63, 0, 0) for c in range(k)]
            if split:
                kw["restart"] = -(-src.shape[1] // 8) * (rps // 8)
        elif split:
            kw["restart_rows"] = rps // (8 * vs)
        if restart:
            kw["restart"] = restart
        jpeg = jpeg_encode(src[..., :1] if grey else src, **kw)
    else:
        kw = dict(quality=quality, optimize=False)
        if not grey:
            kw["subsampling"] = subsampling
        if split:
            kw["restart_marker_rows"] = rps // (8 * vs)
        elif restart:
            kw["restart_marker_blocks"] = restart
        im = PILImage.fromarray(src[..., 0] if grey else src,
                                "L" if grey else "RGB")
        jpeg = _pillow(im, "JPEG", **kw)
    head, scans = _scan_parts(jpeg)
    # each scan split at the restart markers that end strips
    planes = []
    for prefix, scan in scans:
        pieces = [scan]
        if split:
            pieces, start = [], 0
            for i in range(len(scan) - 1):
                if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
                    pieces.append(scan[start:i])
                    start = i + 2
            pieces.append(scan[start:])
        planes.append([prefix + pieces[0]] + pieces[1:])
    pieces = [p for plane in planes for p in plane]
    tags = list(extra_tags)
    if not grey and subsampling_tag != ():
        tags.append((530, 3, subsampling_tag or (hs, vs)))
    blobs = []
    if form == "stream":
        strips = [head + pieces[0]] + pieces[1:]
    elif form == "jif":
        strips = pieces
        blobs.append((513, [head]))
        if jif_length:
            tags.append((514, 4, (len(head),)))
    elif form == "tables":
        strips = pieces
        q, dc, ac, pos = {}, {}, {}, 2
        while pos < len(head):
            m = head[pos + 1]
            n = struct.unpack_from(">H", head, pos + 2)[0]
            body = head[pos + 4:pos + 2 + n]
            if m == 0xDB:
                i = 0
                while i < len(body):
                    q[body[i] & 15] = body[i + 1:i + 65]
                    i += 65
            elif m == 0xC4:
                i = 0
                while i < len(body):
                    cls, tid = body[i] >> 4, body[i] & 15
                    count = sum(body[i + 1:i + 17])
                    (ac if cls else dc)[tid] = body[i + 1:i + 17 + count]
                    i += 17 + count
            elif m == 0xC0:
                comps = [(body[6 + 3 * c], body[8 + 3 * c])
                         for c in range(body[5])]
            elif m == 0xDA:
                sel = [body[2 + 2 * c] for c in range(body[0])]
            pos += 2 + n
        blobs += [(519, [q[t] for _, t in comps]),
                  (520, [dc[s >> 4] for s in sel]),
                  (521, [ac[s & 15] for s in sel])]
        tags.append((512, 3, (1,)))
        if restart:
            tags.append((515, 3, (restart,)))
    else:
        raise ValueError(f"form {form}")
    return tiff_file(np.zeros((h, w, k), np.uint8), 8, photometric,
                     order=order, compression=6, rows_per_strip=rps,
                     raw_strips=strips, extra_tags=tags, blobs=blobs,
                     tile=tile, planar=planar)


def ycbcr_units(px: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """px [h, w, 3] (Y, Cb, Cr) -> libtiff's packed YCbCr rows: for each
    row of hs x vs blocks (partial ones at the right and bottom padded by
    their edge), each block's Y samples row by row, then its top-left Cb
    and Cr; [ceil(h / vs), ceil(w / hs) x (hs x vs + 2)] uint8."""
    h, w, _ = px.shape
    bh, bw = -(-h // vs), -(-w // hs)
    full = np.pad(px, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)),
                  mode="edge")
    ys = full[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3) \
        .reshape(bh, bw, hs * vs)
    chroma = full[::vs, ::hs, 1:]
    return np.concatenate([ys, chroma], axis=2).reshape(bh, -1)


def ycbcr_tiff(px: np.ndarray, hs: int, vs: int, compression: int, *,
               rows_per_strip=None, tile=None, planar: int = 1,
               predictor: int = 1, order: str = "<", extra_tags=()) -> bytes:
    """A photometric 6 TIFF of px [h, w, 3] (Y, Cb, Cr), subsampled hs x
    vs in libtiff's packed data units (or in three planes at 1 x 1 for
    planar 2), in strips of rows_per_strip rows or tiles, each chunk
    compressed by compress_chunk (predictor 2: the horizontal differences
    of libtiff's scanline rows, samples 3 apart)."""
    h, w, _ = px.shape
    chunks = []
    if planar == 2:
        for k in range(3):
            plane = px[..., k:k + 1]
            if tile:
                tw, th = tile
                for ty in range(0, h, th):
                    for tx in range(0, w, tw):
                        blk = np.zeros((th, tw), np.uint8)
                        part = plane[ty:ty + th, tx:tx + tw, 0]
                        blk[:part.shape[0], :part.shape[1]] = part
                        chunks.append(blk)
            else:
                rps = rows_per_strip or h
                chunks += [plane[y:y + rps, :, 0] for y in range(0, h, rps)]
    elif tile:
        tw, th = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                blk = np.pad(px[ty:ty + th, tx:tx + tw],
                             ((0, max(0, ty + th - h)),
                              (0, max(0, tx + tw - w)), (0, 0)), mode="edge")
                chunks.append(ycbcr_units(blk, hs, vs))
    else:
        rps = rows_per_strip or h
        chunks = [ycbcr_units(px[y:y + rps], hs, vs)
                  for y in range(0, h, rps)]
    raws = []
    for c in chunks:
        if predictor == 2:
            # libtiff's predictor rows: the scanline (a block row over vs),
            # a tile's unsubsampled row, or a plane's row
            stride = 3 if planar == 1 else 1
            line = (c.shape[1] if planar == 2 else
                    3 * tile[0] if tile else c.shape[1] // vs)
            rows = c.reshape(-1, line).astype(np.int64)
            c = rows.copy()
            c[:, stride:] = rows[:, stride:] - rows[:, :-stride]
        raws.append(compress_chunk((c & 0xFF).astype(np.uint8).tobytes(),
                                   compression))
    tags = [(530, 3, (hs, vs))] + list(extra_tags)
    return tiff_file(np.zeros((h, w, 3), np.uint8), 8, 6, order=order,
                     compression=compression, planar=planar,
                     predictor=predictor, rows_per_strip=rows_per_strip,
                     tile=tile, raw_strips=raws, extra_tags=tags)


_JPEG_TABLES = (0xC4, 0xDB)          # DHT, DQT


def jpeg_split(jpeg: bytes) -> tuple:
    """A JPEG -> (its tables as a tables-only stream: SOI, the DQT and DHT
    segments, EOI; the abbreviated stream without them)."""
    tables, rest = b"\xff\xd8", b"\xff\xd8"
    pos = 2
    while True:
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            rest += jpeg[pos:]
            break
        n = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        seg = jpeg[pos:pos + 2 + n]
        if marker in _JPEG_TABLES:
            tables += seg
        else:
            rest += seg
        pos += 2 + n
    return tables + b"\xff\xd9", rest


def jpeg_tiff(img: np.ndarray, photometric: int, *, rows_per_strip=None,
              tile=None, subsampling: int = 0, quality: int = 80,
              restart: int = 0, order: str = "<", tables: bool = True,
              last_strip_full: bool = False, extra_tags=()) -> bytes:
    """A JPEG-in-TIFF (compression 7) of img [h, w, k] u8 written as
    libtiff lays it out: each strip or tile a JPEG of its own that Pillow's
    JPEG writer makes (photometric 1: grey; 2: RGB as Adobe RGB, no
    transform; 5: CMYK; 6: JFIF YCbCr at `subsampling` 0, 1 or 2 for 1x1,
    2x1 and 2x2, with YCbCrSubsampling to match), a tile's of the whole
    tile (its edge repeated past the image), and with tables the quality's
    DQT and DHT moved into the JPEGTables tag, each stream abbreviated;
    restart: a restart marker every that many MCUs; last_strip_full: the
    last strip's JPEG as tall as the others, as libtiff allows."""
    h, w, k = img.shape
    mode = {1: "L", 2: "RGB", 5: "CMYK", 6: "RGB"}[photometric]
    kw = dict(quality=quality)
    if photometric == 2:
        kw.update(keep_rgb=True, subsampling=0)
    if photometric == 6:
        kw.update(subsampling=subsampling)
    if restart:
        kw["restart_marker_blocks"] = restart

    def one(part):
        im = PILImage.fromarray(part[..., 0] if mode == "L" else part,
                                "CMYK" if mode == "CMYK" else None)
        return _pillow(im, "JPEG", **kw)

    parts = []
    if tile:
        tw, th = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                parts.append(np.pad(img[ty:ty + th, tx:tx + tw],
                                    ((0, max(0, ty + th - h)),
                                     (0, max(0, tx + tw - w)), (0, 0)),
                                    mode="edge"))
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            part = img[y:y + rps]
            if last_strip_full and len(part) < rps:
                part = np.pad(part, ((0, rps - len(part)), (0, 0), (0, 0)),
                              mode="edge")
            parts.append(part)
    streams = [one(p) for p in parts]
    extra = list(extra_tags)
    if tables:
        split = [jpeg_split(s) for s in streams]
        assert len({t for t, _ in split}) == 1
        streams = [r for _, r in split]
        extra.append((347, 7, split[0][0]))
    if photometric == 6:
        sub = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
        extra.append((530, 3, sub))
    return tiff_file(np.zeros((h, w, k), np.uint8), 8, photometric,
                     order=order, compression=7,
                     rows_per_strip=rows_per_strip, tile=tile,
                     raw_strips=streams, extra_tags=extra)


def pillow_strip(im, compression: str, tiffinfo=None) -> bytes:
    """The one strip Pillow's libtiff writes for the image im: for a
    tile of another TIFF (fax chunks)."""
    from PIL import TiffImagePlugin

    data = _pillow(im, "TIFF", compression=compression,
                   tiffinfo={**(tiffinfo or {}), 278: im.height})
    t = PILImage.open(io.BytesIO(data))
    assert isinstance(t, TiffImagePlugin.TiffImageFile)
    (off,), (n,) = t.tag_v2[273], t.tag_v2[279]
    return data[off:off + n]


def tiff_file(samples: np.ndarray, bits, photometric: int, *,
              order: str = "<", bigtiff: bool = False, compression: int = 1,
              predictor: int = 1, planar: int = 1, rows_per_strip=None,
              tile=None, sample_format=None, extra=(), colormap=None,
              fill_order: int = 1, orientation=None, raw_strips=None,
              extra_tags=(), blobs=()) -> bytes:
    """A TIFF of samples [h, w, spp] (ints, or floats at SampleFormat 3)
    in the given organisation; raw_strips, where given, replaces the
    encoded chunks (for damaged files); blobs, (tag, [bytes, ...]) pairs,
    are written before the chunks, each tag holding their offsets (LONG),
    or a (tag, 0) pair's offset as 0."""
    h, w, spp = samples.shape
    bits = tuple(bits) if isinstance(bits, (tuple, list)) else (bits,) * spp
    b0 = bits[0]
    chunks = []                       # encoded strips or tiles

    def encode(rows_samples, nsamp):
        """rows [r, n] samples of one chunk (n = width x samples)."""
        raw = bytearray()
        for row in rows_samples:
            vals = row
            if predictor == 2:
                vals = _predict2(row, b0, nsamp)
            if predictor == 3:
                raw += _predict3(row.astype("<f" + str(b0 // 8)).tobytes(),
                                 b0 // 8, nsamp)
            else:
                raw += _pack_samples(vals, b0, order)
        raw = bytes(raw)
        if fill_order == 2 and compression == 1:
            raw = bytes(int(f"{x:08b}"[::-1], 2) for x in raw)
        out = compress_chunk(raw, compression)
        if fill_order == 2 and compression != 1:   # libtiff reverses the
            out = bytes(int(f"{x:08b}"[::-1], 2) for x in out)  # codes
        return out

    planes = [samples] if planar == 1 else [samples[..., k:k + 1]
                                            for k in range(spp)]
    for plane in planes:
        n = plane.shape[2]
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, n), plane.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk.reshape(th, tw * n), n))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                part = plane[y:y + rps]
                chunks.append(encode(part.reshape(len(part), w * n), n))
    if raw_strips is not None:
        chunks = raw_strips
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, list(bits)),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in colormap])
    if orientation is not None:
        tags[274] = (3, [orientation])
    for tag, typ, vals in extra_tags:
        tags[tag] = (typ, list(vals))
    if tile:
        tags[322] = (4, [tile[0]])
        tags[323] = (4, [tile[1]])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    # layout: header, blobs, chunk data, then the IFD and its out-of-line
    # values
    data = bytearray(16 if bigtiff else 8)
    for tag, parts in blobs:
        where = []
        for part in parts:
            where.append(len(data) if part else 0)
            data += part
            if len(data) & 1:
                data += b"\0"
        tags[tag] = (4, where)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) & 1:
            data += b"\0"
    off_type = 16 if bigtiff else 4
    tags[off_tag] = (off_type, offsets)
    tags[cnt_tag] = (off_type if bigtiff else 4, [len(c) for c in chunks])
    ifd_pos = len(data)
    entry = 20 if bigtiff else 12
    inline = 8 if bigtiff else 4
    n_tags = len(tags)
    ifd_size = (8 if bigtiff else 2) + n_tags * entry + (8 if bigtiff else 4)
    extra_pos = ifd_pos + ifd_size
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), n_tags))
    blob = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        payload = struct.pack(order + _TYPES[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)  # num, den pairs
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"),
                                extra_pos + len(blob))
            blob += payload
            if len(blob) & 1:
                blob += b"\0"
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, typ,
                           count) + field
    ifd += struct.pack(order + ("Q" if bigtiff else "I"), 0)
    head = (b"II" if order == "<" else b"MM")
    head += struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos) if bigtiff else \
        struct.pack(order + "HI", 42, ifd_pos)
    data[:len(head)] = head
    return bytes(data + ifd + blob)


# ---------------------------------------------------------------- WebP

_WEBP = None


def _libwebp():
    """Pillow's own libwebp (its encoder's advanced API, for the segment,
    filter, partition and alpha settings that Pillow's save does not
    take), loaded with ctypes."""
    global _WEBP
    if _WEBP is None:
        import ctypes
        import glob

        import PIL
        from PIL import _webp  # noqa: F401  (loads libwebp's dependencies)

        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                            "pillow.libs", "libwebp-*.so*")
        _WEBP = ctypes.CDLL(sorted(glob.glob(libs))[0])
    return _WEBP


# WebPConfig's fields in order (encode.h), each 4 bytes
_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size",
           "target_PSNR", "segments", "sns_strength", "filter_strength",
           "filter_sharpness", "filter_type", "autofilter",
           "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
           "show_compressed", "preprocessing", "partitions",
           "partition_limit", "emulate_jpeg_size", "thread_level",
           "low_memory", "near_lossless", "exact", "use_delta_palette",
           "use_sharp_yuv", "qmin", "qmax")


def webp_encode(px: np.ndarray, quality: float = 75.0, **config) -> bytes:
    """px [h, w, 3 or 4] u8 through libwebp's WebPEncode with the given
    WebPConfig fields; the RIFF file."""
    import ctypes

    lib = _libwebp()
    P = ctypes.c_void_p

    class Picture(ctypes.Structure):      # WebPPicture (encode.h), padded
        _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                    ("width", ctypes.c_int), ("height", ctypes.c_int),
                    ("y", P), ("u", P), ("v", P), ("y_stride", ctypes.c_int),
                    ("uv_stride", ctypes.c_int), ("a", P),
                    ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                    ("argb", P), ("argb_stride", ctypes.c_int),
                    ("pad2", ctypes.c_uint32 * 3), ("writer", P),
                    ("custom_ptr", P), ("extra_info_type", ctypes.c_int),
                    ("extra_info", P), ("stats", P),
                    ("error_code", ctypes.c_int), ("progress_hook", P),
                    ("user_data", P), ("pad3", ctypes.c_uint32 * 3),
                    ("pad4", P), ("pad5", P), ("pad6", ctypes.c_uint32 * 8),
                    ("memory_", P), ("memory_argb_", P), ("pad7", P * 2),
                    ("spare", ctypes.c_char * 256)]

    class Writer(ctypes.Structure):       # WebPMemoryWriter, padded
        _fields_ = [("mem", P), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32 * 8)]

    px = np.ascontiguousarray(px, np.uint8)
    abi = 0x0209
    conf = (ctypes.c_int32 * 128)()
    assert lib.WebPConfigInitInternal(conf, 0, ctypes.c_float(quality), abi)
    fconf = ctypes.cast(conf, ctypes.POINTER(ctypes.c_float))
    for k, v in config.items():
        i = _CONFIG.index(k)
        if k == "target_PSNR":
            fconf[i] = v
        else:
            conf[i] = v
    pic = Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    pic.use_argb = int(config.get("lossless", 0))
    pic.height, pic.width = px.shape[:2]
    imp = (lib.WebPPictureImportRGBA if px.shape[2] == 4
           else lib.WebPPictureImportRGB)
    assert imp(ctypes.byref(pic), px.ctypes.data_as(P),
               px.shape[1] * px.shape[2])
    w = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(w))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, P).value
    pic.custom_ptr = ctypes.addressof(w)
    ok = lib.WebPEncode(conf, ctypes.byref(pic))
    out = ctypes.string_at(w.mem, w.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(w))
    assert ok, f"WebPEncode failed ({pic.error_code})"
    return out


def riff_chunks(data: bytes) -> dict:
    """A WebP file's top-level chunks: {fourcc: payload} (the first of
    each)."""
    out, pos = {}, 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.setdefault(tag, data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    return (tag + struct.pack("<I", len(payload)) + payload
            + (b"\0" if len(payload) & 1 else b""))


def riff(*chunks_: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks_)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w: int, h: int, flags: int) -> bytes:
    return chunk(b"VP8X", bytes((flags, 0, 0, 0)) + (w - 1).to_bytes(3,
                 "little") + (h - 1).to_bytes(3, "little"))


def alpha_filtered(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters: 0 none, 1 horizontal, 2 vertical,
    3 gradient (the decoder's unfilter undoes them)."""
    a = alpha.astype(np.int32)
    out = a.copy()
    h, w = a.shape
    for y in range(h):
        for x in range(w):
            if method == 0:
                pred = 0
            elif y == 0:
                pred = a[0, x - 1] if x else 0
            elif method == 1:
                pred = a[y, x - 1] if x else a[y - 1, 0]
            elif method == 2:
                pred = a[y - 1, x]
            elif x == 0:
                pred = a[y - 1, 0]
            else:
                pred = min(255, max(0, a[y, x - 1] + a[y - 1, x]
                                    - a[y - 1, x - 1]))
            out[y, x] = (a[y, x] - pred) & 0xFF
    return out.astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int, lossless: bool) -> bytes:
    """An ALPH chunk of the alpha plane: filtered by method, raw or as a
    headerless VP8L stream of the filtered levels in green."""
    f = alpha_filtered(alpha, method)
    if not lossless:
        return chunk(b"ALPH", bytes((method << 2,)) + f.tobytes())
    g = np.zeros(f.shape + (3,), np.uint8)
    g[..., 1] = f
    vp8l = riff_chunks(webp_encode(g, 100.0, lossless=1, exact=1))[b"VP8L"]
    return chunk(b"ALPH", bytes((1 | method << 2,)) + vp8l[5:])


# ---------------------------------------------------------------- images

def smooth_image(rng, h: int, w: int, noise: float) -> np.ndarray:
    """A seeded sum of sinusoids with Gaussian noise, [h, w, 3] u8."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w, 3), 127.0)
    for _ in range(6):
        fx, fy = rng.uniform(-0.08, 0.08, 2)
        amp = rng.uniform(10, 30, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        img += amp * np.sin(fx * x[..., None] + fy * y[..., None] + ph)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _pillow(im, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def adobe_transform_1(jfif_jpeg: bytes) -> bytes:
    """A JFIF YCbCr JPEG with its APP0 replaced by an Adobe APP14 marker
    of transform 1 (YCbCr)."""
    assert jfif_jpeg[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", jfif_jpeg[4:6])[0]
    app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes(
        (0, 100, 0, 0, 0, 0, 1))
    return jfif_jpeg[:2] + app14 + jfif_jpeg[4 + n:]


def tiff_directory(entries, order: str = "<", head=None) -> bytes:
    """A TIFF header (of `order`, or the bytes `head`) with its offset of 8
    and one IFD of entries (tag, type, count, value bytes), each value of
    over 4 bytes placed after the IFD (its offset from the header's
    start), an `int` value its offset as given; a next-IFD offset of 0."""
    head = head or (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(
        order + "I", 8)
    tail = bytearray()
    body = struct.pack(order + "H", len(entries))
    at = 8 + 2 + 12 * len(entries) + 4
    for tag, typ, count, value in entries:
        if isinstance(value, int):
            field = struct.pack(order + "I", value)
        elif len(value) <= 4:
            field = value.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", at + len(tail))
            tail += value
        body += struct.pack(order + "HHI", tag, typ, count) + field
    return head + body + struct.pack(order + "I", 0) + bytes(tail)


def jpeg_with_segments(jpeg: bytes, segments, jfif: bool = False) -> bytes:
    """A Pillow JPEG with its JFIF APP0 dropped (or kept, jfif) and the
    segments (marker, payload) put after it, before the rest."""
    assert jpeg[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", jpeg[4:6])[0]
    head = jpeg[:4 + n] if jfif else jpeg[:2]
    return head + b"".join(
        bytes((0xFF, m)) + struct.pack(">H", len(p) + 2) + p
        for m, p in segments) + jpeg[4 + n:]


def exif_segment(entries, order: str = "<") -> tuple:
    """An APP1 Exif segment of tiff_directory(entries)."""
    return 0xE1, b"Exif\0\0" + tiff_directory(entries, order)


def mpf_segment(entries, order: str = "<", head=None) -> tuple:
    """An APP2 MPF segment of tiff_directory(entries)."""
    return 0xE2, b"MPF\0" + tiff_directory(entries, order, head)


def mp_entries(offsets_sizes, order: str = "<", fmt: int = 0) -> bytes:
    """MP entries of (data offset, size) images: attribute (the image data
    format `fmt` in bits 24-26, the first a baseline primary image), size,
    offset, two entry numbers of 0."""
    return b"".join(struct.pack(order + "IIIHH", (fmt << 24) | (
        0x030000 if k == 0 else 0x020002), size, off, 0, 0)
        for k, (off, size) in enumerate(offsets_sizes))


def fixtures() -> dict:
    """name -> (kind, file bytes), every fixture made from seed 16."""
    rng = np.random.default_rng(16)
    out = {}
    h, w = 13, 11                                 # odd, Adam7 passes uneven
    names = {0: "grey", 2: "rgb", 3: "palette", 4: "grey_alpha", 6: "rgba"}
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
    for ctype, ds in depths.items():
        for depth in ds:
            for interlace in (False, True):
                ch = _CHANNELS[ctype]
                top = 1 << depth
                px = rng.integers(0, top, (h, w, ch))
                if depth == 16 and ctype == 0:
                    # around and past 255: Pillow saturates 16-bit grey
                    px = rng.choice([0, 7, 200, 255, 256, 1000, 65535],
                                    (h, w, 1))
                palette, trns = None, b""
                if ctype == 3:
                    k = min(top, 6) if depth == 8 else top
                    palette = rng.integers(0, 256, (k, 3))
                    if depth == 8:   # indices past the palette: black
                        px = rng.integers(0, 10, (h, w, 1))
                    trns = bytes((0, 128))
                elif ctype == 0 and depth == 8:
                    trns = struct.pack(">H", 7)
                name = (f"png_{names[ctype]}_{depth}bit"
                        f"{'_adam7' if interlace else ''}.png")
                out[name] = ("png", png_file(px, depth, ctype, interlace,
                                             palette, trns))
    # BMP
    bh, bw = 9, 13
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (200, 3))
    idx1 = rng.integers(0, 2, (bh, bw))
    idx4 = rng.integers(0, 16, (bh, bw))
    idx8 = rng.integers(0, 256, (bh, bw))         # past 200 entries: black

    def nibbles(idx):
        return [bytes((int(r[i]) << 4) | (int(r[i + 1]) if i + 1 < bw else 0)
                      for i in range(0, bw, 2)) for r in idx]

    out["bmp_1bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 1, _rows([np.packbits(r.astype(np.uint8)).tobytes()
                          for r in idx1], (bw + 7) // 8),
        palette=pal16[:2]))
    out["bmp_1bit_core.bmp"] = ("bmp", bmp_file(
        bw, bh, 1, _rows([np.packbits(r.astype(np.uint8)).tobytes()
                          for r in idx1], (bw + 7) // 8),
        header=12, palette=pal16[:2]))
    out["bmp_4bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, _rows(nibbles(idx4), (bw + 1) // 2), palette=pal16))
    out["bmp_4bit_v5_top_down.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, _rows(nibbles(idx4), (bw + 1) // 2), header=124,
        palette=pal16, top_down=True))
    out["bmp_8bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, _rows([r.astype(np.uint8).tobytes() for r in idx8], bw),
        palette=pal256))
    grey = np.stack([np.arange(256)] * 3, axis=1)
    out["bmp_8bit_grey.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, _rows([r.astype(np.uint8).tobytes() for r in idx8], bw),
        palette=grey))
    out["bmp_8bit_rle8.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, rle_stream(idx8, False, rng), compression=1,
        palette=pal256))
    out["bmp_4bit_rle4.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, rle_stream(idx4, True, rng), compression=2,
        palette=pal16))
    # delta and a short row: hand-made (Pillow reads a delta's two
    # offsets after two other bytes)
    delta = bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 0, 0, 2, 9, 9, 1, 1, 4, 7,
                   0, 0, 2, 8, 0, 0, 8, 1, 0, 1])
    out["bmp_8bit_rle8_delta.bmp"] = ("bmp", bmp_file(
        8, 4, 8, delta, compression=1, palette=pal256))
    delta4 = bytes([3, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 0, 0, 0, 2, 9, 9,
                    1, 1, 4, 0x77, 0, 0, 2, 8, 0, 0, 8, 1, 0, 1])
    out["bmp_4bit_rle4_delta.bmp"] = ("bmp", bmp_file(
        8, 4, 4, delta4, compression=2, palette=pal16))
    v16 = rng.integers(0, 65536, (bh, bw)).astype("<u2")
    d16 = _rows([r.tobytes() for r in v16], 2 * bw)
    out["bmp_16bit_555.bmp"] = ("bmp", bmp_file(bw, bh, 16, d16))
    out["bmp_16bit_565_bitfields.bmp"] = ("bmp", bmp_file(
        bw, bh, 16, d16, compression=3, masks=(0xF800, 0x7E0, 0x1F)))
    out["bmp_16bit_555_bitfields_v4.bmp"] = ("bmp", bmp_file(
        bw, bh, 16, d16, compression=3, header=108,
        masks=(0x7C00, 0x3E0, 0x1F)))
    v24 = rng.integers(0, 256, (bh, 3 * bw)).astype(np.uint8)
    d24 = _rows([r.tobytes() for r in v24], 3 * bw)
    out["bmp_24bit.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24))
    out["bmp_24bit_top_down.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24,
                                                     top_down=True))
    out["bmp_24bit_core.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24,
                                                 header=12))
    v32 = rng.integers(0, 2 ** 32, (bh, bw), dtype=np.uint64).astype("<u4")
    d32 = _rows([r.tobytes() for r in v32], 4 * bw)
    out["bmp_32bit.bmp"] = ("bmp", bmp_file(bw, bh, 32, d32))
    out["bmp_32bit_bitfields.bmp"] = ("bmp", bmp_file(
        bw, bh, 32, d32, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00)))
    out["bmp_32bit_bitfields_v5.bmp"] = ("bmp", bmp_file(
        bw, bh, 32, d32, compression=3, header=124,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    # JPEG
    jh, jw = 37, 29                                # not whole MCUs
    im = PILImage.fromarray(smooth_image(rng, jh, jw, 12.0))
    for prog in (False, True):
        mode = "progressive" if prog else "baseline"
        for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
            out[f"jpeg_{mode}_{tag}.jpg"] = ("jpeg", _pillow(
                im, "JPEG", quality=85, subsampling=sub, progressive=prog))
        out[f"jpeg_{mode}_grey.jpg"] = ("jpeg", _pillow(
            im.convert("L"), "JPEG", quality=85, progressive=prog))
        out[f"jpeg_{mode}_adobe_rgb.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, progressive=prog, keep_rgb=True))
        out[f"jpeg_{mode}_420_restart.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, subsampling=2, progressive=prog,
            restart_marker_blocks=3))
        out[f"jpeg_{mode}_422_restart_rows.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, subsampling=1, progressive=prog,
            restart_marker_rows=1))
        out[f"jpeg_{mode}_adobe_ycc.jpg"] = ("jpeg", adobe_transform_1(
            _pillow(im, "JPEG", quality=85, subsampling=2,
                    progressive=prog)))
    small = PILImage.fromarray(smooth_image(rng, 3, 5, 12.0))
    for sub, tag in ((1, "422"), (2, "420")):
        out[f"jpeg_baseline_{tag}_tiny.jpg"] = ("jpeg", _pillow(
            small, "JPEG", quality=90, subsampling=sub))
    big = PILImage.fromarray(smooth_image(rng, 1024, 1024, 4.0))
    out[BIG] = ("jpeg", _pillow(big, "JPEG", quality=90, subsampling=2,
                                progressive=True))
    out.update(tga_fixtures(np.random.default_rng(17)))
    out.update(pnm_fixtures(np.random.default_rng(18)))
    out.update(gif_fixtures(np.random.default_rng(19)))
    out.update(psd_fixtures(np.random.default_rng(20)))
    out.update(tiff_fixtures(np.random.default_rng(21)))
    texels = np.asarray(PILImage.open(io.BytesIO(out[BIG][1])).convert("RGB"))
    out.update(webp_fixtures(np.random.default_rng(22), texels))
    out.update(dds_fixtures(np.random.default_rng(23)))
    out.update(tiff_codec_fixtures(np.random.default_rng(24)))
    out[TIFF_JPEG_BIG] = ("tiff", jpeg_tiff(texels, 6, tile=(256, 256),
                                            subsampling=2, quality=85))
    out.update(jpeg_variant_fixtures(np.random.default_rng(25), texels))
    out.update(asset_fixtures(np.random.default_rng(26)))
    out.update(j2k_fixtures(np.random.default_rng(27)))
    return out


def cmyk_of(rgb: np.ndarray) -> np.ndarray:
    """[h, w, 3] u8 RGB -> [h, w, 4] u8 CMYK as Adobe stores it (inverted,
    as Pillow's "CMYK;I" reads it back): K takes all the grey, 255 less
    the largest channel, and C, M, Y what Pillow's cmyk2rgb turns back
    into the channels, nk - v x nk / 255 with nk = 255 - K."""
    x = rgb.astype(np.float64)
    top = x.max(-1, keepdims=True)
    cmy = np.where(top > 0, 255.0 * (1.0 - x / np.maximum(top, 1.0)), 0.0)
    cmyk = np.concatenate([np.rint(cmy), 255.0 - top], -1)
    return (255 - cmyk).astype(np.uint8)


# the 18c crop: the 1024x1024 texels' top-left 256x256, arithmetic-coded,
# progressive, YCCK at 4:4:0 (Y and K 1x2), with a scan script that leaves
# the first AC band of Y approximate (one bit unrefined), so that block
# smoothing runs too
JPEG_CROP = 256
JPEG_CROP_NAME = f"jpeg_ycck_440_arith_progressive_smoothed_{JPEG_CROP}.jpg"
JPEG_CROP_SCANS = [((0, 1, 2, 3), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                   ((0,), 6, 63, 0, 1), ((1,), 1, 63, 0, 0),
                   ((2,), 1, 63, 0, 0), ((3,), 1, 63, 0, 1),
                   ((0,), 1, 5, 2, 1), ((0, 1, 2, 3), 0, 0, 1, 0)]
# scan scripts that leave coefficients unrefined (block smoothing), by name
SMOOTH_SCANS = {
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc_al1": [((0, 1, 2), 0, 0, 0, 1)],
    "ac_al2": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 2),
               ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    "partial_bands": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 2, 0, 0),
                      ((1,), 1, 9, 0, 1), ((2,), 3, 63, 0, 0),
                      ((0, 1, 2), 0, 0, 1, 0)],
}
# sampling factors of each component, by name
SAMPLINGS = {
    "440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
    "410": [(4, 2), (1, 1), (1, 1)], "311": [(3, 1), (1, 1), (1, 1)],
    "mixed": [(2, 2), (2, 1), (1, 1)], "chroma_up": [(1, 1), (1, 2), (2, 1)],
    "441": [(1, 4), (1, 1), (1, 1)], "421_12": [(2, 2), (1, 2), (2, 1)],
}


def jpeg_variant_fixtures(rng, texels: np.ndarray) -> dict:
    """The JPEG variants Pillow opens but does not write, through
    Pillow's own libjpeg-turbo (jpeg_encode): every whole sampling ratio,
    CMYK and YCCK, arithmetic coding, scan scripts that leave coefficients
    unrefined (block smoothing) and lossless, and the 18c crop."""
    out = {}
    px = smooth_image(rng, 21, 19, 12.0)

    def add(name, img, **kw):
        out[f"jpeg_{name}.jpg"] = ("jpeg", jpeg_encode(img, quality=75, **kw))

    for name, samp in SAMPLINGS.items():
        add(f"sampling_{name}", px, sampling=samp)
    add("sampling_440_narrow", px[:, :3], sampling=SAMPLINGS["440"])
    add("sampling_422_narrow", px[:, :4], sampling=[(2, 1), (1, 1), (1, 1)])
    add("sampling_adobe_rgb_440", px, colorspace="rgb",
        sampling=SAMPLINGS["440"])
    add("sampling_progressive_411", px, progressive=True,
        sampling=SAMPLINGS["411"])
    cmyk = cmyk_of(px)
    add("cmyk_adobe", cmyk)
    add("cmyk_no_adobe", cmyk, adobe=False)
    add("cmyk_progressive", cmyk, progressive=True)
    add("ycck", cmyk, colorspace="ycck")
    add("ycck_420", cmyk, colorspace="ycck",
        sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    out["jpeg_cmyk_pillow.jpg"] = ("jpeg", _pillow(
        PILImage.fromarray(cmyk, "CMYK"), "JPEG", quality=75))
    add("arith_sequential", px, arithmetic=True,
        sampling=[(2, 2), (1, 1), (1, 1)])
    add("arith_progressive", px, arithmetic=True, progressive=True)
    add("arith_restart", px, arithmetic=True, restart=2)
    add("arith_dac", px, arithmetic=True, tables=[(0, 0), (1, 1), (1, 1)],
        conditioning={0: (2, 4, 3), 1: (0, 0, 20)})
    add("arith_grey", px[..., :1], arithmetic=True)
    add("arith_progressive_restart_dac", px, arithmetic=True,
        progressive=True, restart=3, conditioning={0: (1, 3, 1)})
    for name, scans in SMOOTH_SCANS.items():
        add(f"smooth_{name}", px, scans=scans)
        add(f"arith_smooth_{name}", px, scans=scans, arithmetic=True)
    add("smooth_grey_dc_only", px[..., :1], scans=[((0,), 0, 0, 0, 0)])
    grey = px[:13, :17, :1]
    for psv in range(1, 8):
        add(f"lossless_p{psv}", grey, lossless=(psv, 0))
    add("lossless_grey_pt3", grey, lossless=(6, 3))
    add("lossless_rgb_pt2", px[:13, :17], lossless=(4, 2))
    add("lossless_cmyk", cmyk[:13, :17], lossless=(7, 0))
    add("lossless_restart", px[:13, :17], lossless=(5, 1), restart_rows=2)
    crop = cmyk_of(texels[:JPEG_CROP, :JPEG_CROP])
    out[JPEG_CROP_NAME] = ("jpeg", jpeg_encode(
        crop, quality=70, colorspace="ycck", arithmetic=True,
        sampling=[(1, 2), (1, 1), (1, 1), (1, 2)], scans=JPEG_CROP_SCANS))
    return out


def _sof(data: bytes) -> int:
    """The offset of a JPEG's frame header marker."""
    for m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        i = data.find(bytes((0xFF, m)))
        if i > 0:
            return i
    raise ValueError("no frame header")


def _patched(data: bytes, changes: dict) -> bytes:
    out = bytearray(data)
    for pos, value in changes.items():
        out[pos] = value
    return bytes(out)


def _lossless_diffs(plane: np.ndarray, psv: int, pt: int,
                    restart_rows: int) -> np.ndarray:
    """The differences of a component's samples [h, w] >> pt under
    predictor psv (T.81 H.1.2.1): the first row of the plane and of each
    restart segment from 2^(7 - pt) and the left neighbour, each other
    row's first sample from the one above; modulo 2^16."""
    x = plane.astype(np.int64) >> pt
    h, w = x.shape
    d = np.zeros_like(x)
    for y in range(h):
        first = y == 0 or (restart_rows and y % restart_rows == 0)
        for c in range(w):
            if first:
                p = (1 << (7 - pt)) if c == 0 else x[y, c - 1]
            elif c == 0:
                p = x[y - 1, 0]
            else:
                ra, rb, rc = x[y, c - 1], x[y - 1, c], x[y - 1, c - 1]
                p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                     5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                     7: (ra + rb) >> 1}[psv]
            d[y, c] = (x[y, c] - p) & 0xFFFF
    return d


def lossless_jpeg(planes, factors, psv: int, pt: int = 0,
                  restart_mcu_rows: int = 0) -> bytes:
    """An 8-bit lossless JPEG (SOF3, Adobe RGB) of one interleaved scan
    whose components [h_i, w_i] u8 have the sampling factors `factors`:
    libjpeg's compressor writes lossless at 1x1 only. Huffman table 0
    codes every category (0-16) in 5 bits; samples past a component's
    edge in the MCUs have difference 0."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    top = [i for i, f in enumerate(factors) if f == (hmax, vmax)][0]
    height, width = planes[top].shape
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    ids = (82, 71, 66)
    sof = struct.pack(">BHHB", 8, height, width, len(planes)) + b"".join(
        bytes((cid, h << 4 | v, 0)) for cid, (h, v) in zip(ids, factors))
    dht = bytes((0,)) + bytes((0, 0, 0, 0, 17) + (0,) * 11) + bytes(range(17))
    sos = (bytes((len(planes),)) + b"".join(bytes((cid, 0))
                                            for cid in ids[:len(planes)])
           + bytes((psv, 0, pt)))
    out = bytearray(b"\xff\xd8\xff\xee\x00\x0eAdobe\x00\x64" + bytes(5))
    for marker, body in ((0xC3, sof), (0xC4, dht)):
        out += bytes((0xFF, marker)) + struct.pack(">H", 2 + len(body)) + body
    if restart_mcu_rows:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart_mcu_rows * mcux)
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    diffs = [_lossless_diffs(p, psv, pt, restart_mcu_rows * v)
             for p, (_, v) in zip(planes, factors)]
    bits = []

    def flush():
        bits.extend([1] * (-len(bits) % 8))
        for i in range(0, len(bits), 8):
            byte = int("".join(map(str, bits[i:i + 8])), 2)
            out.extend(b"\xff\x00" if byte == 0xFF else bytes((byte,)))
        bits.clear()

    for my in range(mcuy):
        if restart_mcu_rows and my and my % restart_mcu_rows == 0:
            flush()
            out.extend(bytes((0xFF, 0xD0 + (my // restart_mcu_rows - 1) % 8)))
        for mx in range(mcux):
            for d, (h, v) in zip(diffs, factors):
                for y in range(my * v, my * v + v):
                    for x in range(mx * h, mx * h + h):
                        val = int(d[y, x]) if y < d.shape[0] and \
                            x < d.shape[1] else 0
                        sv = val - 65536 if val >= 32768 else val
                        s = 16 if val == 32768 else abs(sv).bit_length()
                        bits.extend(int(b) for b in f"{s:05b}")
                        if 0 < s < 16:
                            raw = sv if sv >= 0 else sv + (1 << s) - 1
                            bits.extend(int(b) for b in f"{raw:0{s}b}")
    flush()
    return bytes(out + b"\xff\xd9")


# the JPEGs that Pillow 12 (libjpeg-turbo 3.1) refuses, by case
JPEG_REFUSED = (
    "arithmetic_64k", "lossless_ycc", "lossless_ycck", "lossless_restart",
    "cmyk_mcu", "440_mcu", "411_mcu", "fractional_h", "fractional_v",
    "12-bit", "16-bit", "two_components", "sof5", "sof6", "sof7", "sof11",
    "sof13", "sof14", "sof15", "dnl_height0", "reserved_marker")


def jpeg_refused(case: str) -> bytes:
    """A JPEG of case `case` (JPEG_REFUSED): an arithmetic-coded scan past
    Pillow's first 64 KB block, lossless YCbCr or YCCK (libjpeg converts no
    colours there) or with restarts that are no whole MCU rows, MCUs of
    more than 10 blocks (CMYK, 4:4:0, 4:1:1), fractional sampling ratios,
    12- and 16-bit samples, two components, hierarchical (SOF5-7, SOF13-15)
    and lossless arithmetic (SOF11) frames, a height left to a DNL marker,
    a reserved marker; written by libjpeg where it writes them, else
    patched from a file it writes."""
    rng = np.random.default_rng(JPEG_REFUSED.index(case))
    px = smooth_image(rng, 21, 19, 12.0)
    if case == "arithmetic_64k":
        noise = rng.integers(0, 256, (320, 320, 3), dtype=np.uint8)
        return jpeg_encode(noise, quality=90, arithmetic=True)
    if case.startswith("lossless"):
        if case == "lossless_restart":
            data = jpeg_encode(px, lossless=(1, 0), restart_rows=1)
            dri = data.find(b"\xff\xdd")
            return _patched(data, {dri + 5: 3})       # 3 MCUs, rows of 19
        img = cmyk_of(px) if case == "lossless_ycck" else px
        data = jpeg_encode(img, lossless=(1, 0))
        adobe = data.find(b"Adobe")
        return _patched(data, {adobe + 11: 2 if case == "lossless_ycck"
                               else 1})
    if case == "cmyk_mcu":
        data = jpeg_encode(cmyk_of(px))
        i = _sof(data)
        return _patched(data, {i + 11 + 3 * k: 0x22 for k in range(4)})
    if case in ("440_mcu", "411_mcu"):
        data = jpeg_encode(px)
        i = _sof(data)
        y, c = (0x24, 0x22) if case == "440_mcu" else (0x42, 0x12)
        return _patched(data, {i + 11: y, i + 14: c, i + 17: c})
    if case.startswith("fractional"):
        data = jpeg_encode(px, sampling=[(3, 1), (1, 1), (1, 1)]
                           if case == "fractional_h"
                           else [(1, 3), (1, 1), (1, 1)])
        return _patched(data, {_sof(data) + 14: 0x21 if case ==
                               "fractional_h" else 0x12})
    if case in ("12-bit", "16-bit"):
        data = jpeg_encode(px)
        return _patched(data, {_sof(data) + 4: int(case[:2])})
    if case == "two_components":
        return jpeg_encode(px[..., :2])
    if case.startswith("sof"):
        data = jpeg_encode(px[..., :1], lossless=(1, 0)) if case == "sof11" \
            else jpeg_encode(px)
        return _patched(data, {_sof(data) + 1: 0xC0 + int(case[3:])})
    if case == "dnl_height0":
        data = jpeg_encode(px)
        i = _sof(data)
        return _patched(data, {i + 5: 0, i + 6: 0})
    if case == "reserved_marker":
        data = jpeg_encode(px)
        sos = data.find(b"\xff\xda")
        return data[:sos] + b"\xff\xf1\x00\x04ab" + data[sos:]
    raise ValueError(f"no refused JPEG case {case!r}")


TIFF_COMPRESSIONS = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}


def tiff_fixtures(rng) -> dict:
    """Every mode of Pillow's table that convert("RGB") takes (but YCbCr
    and LAB), raw, LZW, Deflate and PackBits; predictors 2 and 3, planar
    configuration 2, tiles, FillOrder 2, MinIsWhite, associated and
    unassociated alpha, BigTIFF, big-endian files, old-style LZW codes,
    each Orientation, and files Pillow writes."""
    h, w = 13, 11
    out = {}

    def draw(bits, spp, kind="u"):
        if kind == "f":
            v = rng.normal(100, 150, (h, w, spp)).astype(np.float32)
            v.flat[:4] = (0.5, 254.9, np.inf, np.nan)  # truncation, clips
            return v
        if kind == "i":
            dt = {16: np.int16, 32: np.int32}[bits]
            return rng.integers(-600, 600, (h, w, spp)).astype(dt)
        dt = np.uint32 if bits > 16 else np.uint16 if bits > 8 else np.uint8
        top = 1 << bits
        if bits in (12, 16, 32):       # around and past 255: saturation
            return rng.choice([0, 7, 200, 255, 256, 1000, top - 1],
                              (h, w, spp)).astype(dt)
        return rng.integers(0, top, (h, w, spp)).astype(dt)

    def cmap(bits):
        return rng.integers(0, 65536, 3 << bits)

    modes = {   # name: (samples, bits, photometric, options)
        "bilevel": (draw(1, 1), 1, 1, {}),
        "bilevel_min_is_white": (draw(1, 1), 1, 0, {}),
        "grey2": (draw(2, 1), 2, 1, {}),
        "grey2_min_is_white": (draw(2, 1), 2, 0, {}),
        "grey4": (draw(4, 1), 4, 1, {}),
        "grey4_min_is_white": (draw(4, 1), 4, 0, {}),
        "grey8": (draw(8, 1), 8, 1, {}),
        "grey8_min_is_white": (draw(8, 1), 8, 0, {}),
        "grey8_signed": (draw(8, 1), 8, 1, dict(sample_format=2)),
        "grey12": (draw(12, 1), 12, 1, {}),
        "grey16": (draw(16, 1), 16, 1, {}),
        "grey16_min_is_white": (draw(16, 1), 16, 0, {}),
        "grey16_signed": (draw(16, 1, "i"), 16, 1, dict(sample_format=2)),
        "grey32": (draw(32, 1), 32, 1, {}),
        "grey32_signed": (draw(32, 1, "i"), 32, 1, dict(sample_format=2)),
        "float": (draw(32, 1, "f"), 32, 1, dict(sample_format=3)),
        "float_min_is_white": (draw(32, 1, "f"), 32, 0,
                               dict(sample_format=3)),
        "grey_alpha": (draw(8, 2), 8, 1, dict(extra=(2,))),
        "rgb": (draw(8, 3), 8, 2, {}),
        "rgba": (draw(8, 4), 8, 2, dict(extra=(2,))),
        "rgba_no_extra_samples": (draw(8, 4), 8, 2, {}),
        "rgba_associated": (draw(8, 4), 8, 2, dict(extra=(1,))),
        "rgba_corel": (draw(8, 4), 8, 2, dict(extra=(999,))),
        "rgbx": (draw(8, 4), 8, 2, dict(extra=(0,))),
        "rgbxx": (draw(8, 5), 8, 2, dict(extra=(0, 0))),
        "rgba_associated_x": (draw(8, 5), 8, 2, dict(extra=(1, 0))),
        "rgba_x_x": (draw(8, 6), 8, 2, dict(extra=(2, 0, 0))),
        "rgb16": (draw(16, 3), 16, 2, {}),
        "rgba16": (draw(16, 4), 16, 2, dict(extra=(2,))),
        "rgba16_associated": (draw(16, 4), 16, 2, dict(extra=(1,))),
        "rgbx16": (draw(16, 4), 16, 2, dict(extra=(0,))),
        "palette1": (draw(1, 1), 1, 3, dict(colormap=cmap(1))),
        "palette2": (draw(2, 1), 2, 3, dict(colormap=cmap(2))),
        "palette4": (draw(4, 1), 4, 3, dict(colormap=cmap(4))),
        "palette8": (draw(8, 1), 8, 3, dict(colormap=cmap(8))),
        "palette_x": (draw(8, 2), 8, 3, dict(extra=(0,), colormap=cmap(8))),
        "palette_alpha": (draw(8, 2), 8, 3, dict(extra=(2,),
                                                 colormap=cmap(8))),
        "cmyk": (draw(8, 4), 8, 5, {}),
        "cmykx": (draw(8, 5), 8, 5, dict(extra=(0,))),
        "cmyk16": (draw(16, 4), 16, 5, {}),
        "ycbcr_grey": (draw(8, 1), 8, 6, {}),
    }
    for name, (px, bits, photo, kw) in modes.items():
        for cname, comp in TIFF_COMPRESSIONS.items():
            if photo == 6 and comp != 1:
                continue                  # libtiff refuses it compressed
            out[f"tiff_{name}_{cname}.tif"] = ("tiff", tiff_file(
                px, bits, photo, compression=comp, rows_per_strip=5, **kw))
    big_endian = ("grey16", "grey16_signed", "grey32_signed", "float", "rgb",
                  "rgb16", "rgba16_associated", "cmyk16", "palette8",
                  "bilevel")
    for name in big_endian:
        px, bits, photo, kw = modes[name]
        for cname in ("raw", "lzw"):
            out[f"tiff_{name}_be_{cname}.tif"] = ("tiff", tiff_file(
                px, bits, photo, order=">",
                compression=TIFF_COMPRESSIONS[cname], **kw))
    for name, cname, pred, order in (
            ("rgb", "lzw", 2, "<"), ("rgb", "deflate", 2, ">"),
            ("grey8", "lzw", 2, "<"), ("grey16", "lzw", 2, "<"),
            ("grey16", "deflate", 2, ">"), ("grey32_signed", "lzw", 2, "<"),
            ("rgba16", "deflate", 2, "<"), ("rgb16", "lzw", 2, ">"),
            ("cmyk", "deflate", 2, "<"), ("rgb", "packbits", 2, "<"),
            ("float", "deflate", 3, "<"), ("float", "lzw", 3, "<"),
            ("float", "lzw", 3, ">")):
        px, bits, photo, kw = modes[name]
        end = "_be" if order == ">" else ""
        out[f"tiff_{name}{end}_{cname}_predictor{pred}.tif"] = (
            "tiff", tiff_file(px, bits, photo, order=order, predictor=pred,
                              compression=TIFF_COMPRESSIONS[cname],
                              rows_per_strip=4, **kw))
    for name, cname, extra_kw in (
            ("rgb", "raw", {}), ("rgb", "lzw", dict(predictor=2)),
            ("rgba_associated", "deflate", {}), ("rgba_no_extra_samples",
                                                 "lzw", {}),
            ("cmyk", "packbits", {}), ("rgb16", "lzw", dict(predictor=2)),
            ("rgba16_associated", "deflate", {}), ("grey_alpha", "lzw", {}),
            ("grey8", "raw", {})):
        px, bits, photo, kw = modes[name]
        out[f"tiff_{name}_planar_{cname}.tif"] = ("tiff", tiff_file(
            px, bits, photo, planar=2, rows_per_strip=6,
            compression=TIFF_COMPRESSIONS[cname], **extra_kw, **kw))
    big = smooth_image(rng, 40, 37, 6.0)
    for cname, extra_kw in (("raw", {}), ("lzw", dict(predictor=2)),
                            ("deflate", {}), ("packbits", {}),
                            ("deflate", dict(planar=2))):
        tag = "_planar" if extra_kw.get("planar") else ""
        tag += "_predictor2" if extra_kw.get("predictor") else ""
        out[f"tiff_rgb_tiles_{cname}{tag}.tif"] = ("tiff", tiff_file(
            big, 8, 2, tile=(16, 32), compression=TIFF_COMPRESSIONS[cname],
            **extra_kw))
    for name, cname in (("grey8", "raw"), ("rgb", "raw"), ("bilevel", "raw"),
                        ("grey4", "raw"), ("grey16", "raw"), ("rgb", "lzw"),
                        ("bilevel", "packbits"), ("palette2", "deflate"),
                        ("grey8_min_is_white", "lzw")):
        px, bits, photo, kw = modes[name]
        out[f"tiff_{name}_fill_order2_{cname}.tif"] = ("tiff", tiff_file(
            px, bits, photo, fill_order=2,
            compression=TIFF_COMPRESSIONS[cname], **kw))
    rgb = modes["rgb"][0]
    out["tiff_rgb_bigtiff_lzw.tif"] = ("tiff", tiff_file(
        rgb, 8, 2, bigtiff=True, compression=5, predictor=2))
    out["tiff_rgb_bigtiff_raw_strips.tif"] = ("tiff", tiff_file(
        rgb, 8, 2, bigtiff=True, rows_per_strip=3))
    lsb = tiff_file(rgb, 8, 2, compression=5, raw_strips=[tiff_lzw(
        modes["rgb"][0].tobytes(), lsb=True)])
    out["tiff_rgb_lzw_old_style.tif"] = ("tiff", lsb)
    runs = np.repeat(rng.integers(0, 3, (60, 10, 3)), 9, axis=1).astype(
        np.uint8)
    out["tiff_rgb_lzw_long_codes.tif"] = ("tiff", tiff_file(
        runs, 8, 2, compression=5))        # wide codes and Clear codes
    for orientation in range(2, 9):
        out[f"tiff_rgb_orientation{orientation}.tif"] = ("tiff", tiff_file(
            rgb, 8, 2, orientation=orientation, compression=5))
    im = PILImage.fromarray(smooth_image(rng, 9, 14, 10.0))
    for mode in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "I", "F"):
        m = im.convert(mode) if mode not in ("I;16", "I", "F") else \
            im.convert("L").convert(mode)
        for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            key = mode.replace(";", "").lower()
            out[f"tiff_pillow_{key}_{comp}.tif"] = ("tiff", _pillow(
                m, "TIFF", compression=comp))
    out["tiff_pillow_rgb_lzw_predictor2.tif"] = ("tiff", _pillow(
        im, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}))
    return out


def zstd_runs_frame(data: bytes) -> bytes:
    """A ZSTD frame of data written block by block here: runs of 8 or
    more equal bytes alternately as RLE blocks and as compressed blocks of
    RLE literals and no sequences, the bytes between as raw blocks (1 KiB
    window, no content size)."""
    blocks = []
    i, n, flip = 0, len(data), False
    while i < n:
        j = i
        while j < n and j - i < 1024 and data[j] == data[i]:
            j += 1
        if j - i >= 8:
            size = j - i
            if flip:
                blocks.append((1, size, bytes((data[i],))))
            else:
                lit = bytes((((size & 15) << 4) | 0b0101, size >> 4,
                             data[i], 0))
                blocks.append((2, len(lit), lit))
            flip = not flip
            i = j
            continue
        j = i
        while j < n and j - i < 1024 and not (
                j + 8 <= n and len(set(data[j:j + 8])) == 1):
            j += 1
        blocks.append((0, j - i, data[i:j]))
        i = j
    out = bytearray(struct.pack("<IBB", 0xFD2FB528, 0, 0))
    for k, (typ, size, body) in enumerate(blocks):
        head = (size << 3) | (typ << 1) | (k == len(blocks) - 1)
        out += struct.pack("<I", head)[:3] + body
    return bytes(out)


def tiff_codec_fixtures(rng) -> dict:
    """TIFF's JPEG (7), CCITT (2, 3, 4), LZMA and ZSTD compressions and
    YCbCr through libtiff's RGBA path: JPEG in grey, RGB, CMYK and YCbCr at
    1x1, 2x1 and 2x2 in strips and tiles, with and without JPEGTables,
    restart markers, a last strip's stream past the image, a missing
    YCbCrSubsampling; CCITT RLE, Group 3 1D and 2D with and without fill
    bits, Group 4, both photometrics, FillOrder 2, strips, tiles, wide rows
    (the extended make-up codes), rows without EOLs and damaged rows that
    libtiff repairs; LZMA and ZSTD in several modes with predictors, tiles,
    planes and both byte orders, a hand-made ZSTD frame of RLE literals,
    RLE and raw blocks; YCbCr at 1x1 to 4x4 under LZW, Deflate, PackBits,
    LZMA and ZSTD, in strips (a 4x4 strip that libtiff reads short) and
    tiles (a cut 4x4 tile), planar, with predictor 2 (refused quietly by
    libtiff at 2x1), ReferenceBlackWhite and YCbCrCoefficients set, an
    Orientation; and Pillow's own JPEG, CCITT, LZMA and ZSTD files. Odd
    sizes throughout (no whole JPEG MCU or YCbCr block)."""
    out = {}
    img = smooth_image(rng, 21, 19, 14.0)
    grey = img[..., :1]
    cmyk = np.concatenate([img, 255 - img[..., :1]], -1)
    for name, src, photo, sub in (("grey", grey, 1, 0), ("rgb", img, 2, 0),
                                  ("cmyk", cmyk, 5, 0),
                                  ("ycbcr11", img, 6, 0),
                                  ("ycbcr21", img, 6, 1),
                                  ("ycbcr22", img, 6, 2)):
        out[f"tiff_jpeg_{name}.tif"] = ("tiff", jpeg_tiff(
            src, photo, rows_per_strip=16, subsampling=sub))
    for name, src, photo, sub in (("grey", grey, 1, 0), ("rgb", img, 2, 0),
                                  ("ycbcr22", img, 6, 2)):
        out[f"tiff_jpeg_{name}_tiles.tif"] = ("tiff", jpeg_tiff(
            src, photo, tile=(16, 16), subsampling=sub))
    for tag, kw in (("be", dict(order=">")), ("restart", dict(restart=1)),
                    ("no_tables", dict(tables=False)),
                    ("last_strip_full", dict(last_strip_full=True)),
                    ("q30", dict(quality=30))):
        out[f"tiff_jpeg_ycbcr22_{tag}.tif"] = ("tiff", jpeg_tiff(
            img, 6, rows_per_strip=16, subsampling=2, **kw))
    out["tiff_jpeg_ycbcr21_restart3_tiles.tif"] = ("tiff", jpeg_tiff(
        img, 6, tile=(16, 16), subsampling=1, restart=3))
    # no YCbCrSubsampling tag: libtiff takes the first stream's sampling
    no_sub = jpeg_tiff(img, 6, rows_per_strip=16, subsampling=1)
    entry = struct.pack("<HHIHH", 530, 3, 2, 2, 1)
    assert no_sub.count(entry) == 1
    out["tiff_jpeg_ycbcr21_no_subsampling_tag.tif"] = ("tiff", no_sub.replace(
        entry, struct.pack("<HHIHH", 32999, 3, 2, 2, 1)))
    # FillOrder 2: libtiff leaves JPEG bytes as they are
    out["tiff_jpeg_rgb_fill_order2.tif"] = ("tiff", jpeg_tiff(
        img, 2, rows_per_strip=16, extra_tags=[(266, 3, [2])]))
    # CCITT: runs of black and white, one wide image for the long codes
    bw = np.repeat(rng.random((23, 12)) < 0.4, 4, axis=1)[:, :45]
    bw ^= rng.random(bw.shape) < 0.05
    im1 = PILImage.fromarray(bw)
    wide = PILImage.fromarray(np.repeat(rng.random((3, 14)) < 0.5, 200,
                                        axis=1)[:, :2700])
    ccitt = {"rle": ("tiff_ccitt", {}), "group3": ("group3", {292: 0}),
             "group3_2d": ("group3", {292: 1}),
             "group3_fill": ("group3", {292: 4}),
             "group3_2d_fill": ("group3", {292: 5}),
             "group4": ("group4", {})}
    for name, (comp, info) in ccitt.items():
        out[f"tiff_bilevel_{name}.tif"] = ("tiff", _pillow(
            im1, "TIFF", compression=comp, tiffinfo=info))
    for name, comp, info in (
            ("group4_min_is_white", "group4", {262: 0}),
            ("group3_2d_min_is_white", "group3", {292: 1, 262: 0}),
            ("rle_fill_order2", "tiff_ccitt", {266: 2}),
            ("group3_2d_fill_order2", "group3", {292: 5, 266: 2}),
            ("group4_fill_order2", "group4", {266: 2}),
            ("group3_2d_strips", "group3", {292: 1, 278: 5}),
            ("group4_strips", "group4", {278: 4}),
            ("rle_strips", "tiff_ccitt", {278: 6})):
        out[f"tiff_bilevel_{name}.tif"] = ("tiff", _pillow(
            im1, "TIFF", compression=comp, tiffinfo=info))
    for name, comp in (("group3", "group3"), ("group4", "group4")):
        out[f"tiff_bilevel_wide_{name}.tif"] = ("tiff", _pillow(
            wide, "TIFF", compression=comp))
    # tiles and big-endian files of Pillow's own CCITT streams
    px1 = np.asarray(im1)[..., None].astype(np.uint8)
    for name, comp, num, info in (("group4", "group4", 4, {}),
                                  ("group3_2d", "group3", 3, {292: 1})):
        tiles = []
        for ty in range(0, 23, 16):
            for tx in range(0, 45, 16):
                blk = np.zeros((16, 16), bool)
                part = bw[ty:ty + 16, tx:tx + 16]
                blk[:part.shape[0], :part.shape[1]] = part
                tiles.append(pillow_strip(PILImage.fromarray(blk), comp,
                                          info))
        extra = [(292, 4, [info[292]])] if 292 in info else []
        out[f"tiff_bilevel_{name}_tiles.tif"] = ("tiff", tiff_file(
            px1, 1, 1, compression=num, tile=(16, 16), raw_strips=tiles,
            extra_tags=extra))
        strip = pillow_strip(im1, comp, info)
        out[f"tiff_bilevel_{name}_be.tif"] = ("tiff", tiff_file(
            px1, 1, 1, order=">", compression=num, raw_strips=[strip],
            extra_tags=extra))
    # Group 3 without EOLs (libtiff's no-EOL mode), and damaged rows
    g3 = pillow_strip(im1, "group3", {292: 0})
    bits = "".join(f"{b:08b}" for b in g3).replace("000000000001", "")
    bits += "0" * (-len(bits) % 8)
    no_eol = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    out["tiff_bilevel_group3_no_eol.tif"] = ("tiff", tiff_file(
        px1, 1, 1, compression=3, raw_strips=[no_eol],
        extra_tags=[(292, 4, [0])]))
    for name, comp, num, info, flips in (
            ("group3_damaged", "group3", 3, {292: 0}, (40, 41, 97)),
            ("group3_2d_damaged", "group3", 3, {292: 1}, (60, 150)),
            ("rle_damaged", "tiff_ccitt", 2, {}, (30,))):
        data = bytearray(pillow_strip(im1, comp, info))
        for j in flips:
            data[j] ^= 0x24
        extra = [(292, 4, [info[292]])] if 292 in info else []
        out[f"tiff_bilevel_{name}.tif"] = ("tiff", tiff_file(
            px1, 1, 1, compression=num, raw_strips=[bytes(data)],
            extra_tags=extra))
    # LZMA and ZSTD
    small = smooth_image(rng, 13, 11, 10.0)
    samples = {"grey8": (small[..., :1], 8, 1, {}),
               "rgb": (small, 8, 2, {}),
               "rgba": (np.concatenate([small, small[..., :1]], -1), 8, 2,
                        dict(extra=(2,))),
               "grey16": ((small[..., :1].astype(np.uint16) * 257), 16, 1,
                          {}),
               "float": (small[..., :1].astype(np.float32) * 1.5, 32, 1,
                         dict(sample_format=3)),
               "cmyk": (cmyk[:13, :11], 8, 5, {}),
               "bilevel": ((small[..., :1] > 127).astype(np.uint8), 1, 1,
                           {})}
    for cname, num in (("lzma", 34925), ("zstd", 50000)):
        for name, (px, bits_, photo, kw) in samples.items():
            out[f"tiff_{name}_{cname}.tif"] = ("tiff", tiff_file(
                px, bits_, photo, compression=num, rows_per_strip=5, **kw))
        for name, pred, order in (("rgb", 2, "<"), ("grey16", 2, ">"),
                                  ("float", 3, "<")):
            px, bits_, photo, kw = samples[name]
            end = "_be" if order == ">" else ""
            out[f"tiff_{name}{end}_{cname}_predictor{pred}.tif"] = (
                "tiff", tiff_file(px, bits_, photo, order=order,
                                  compression=num, predictor=pred,
                                  rows_per_strip=4, **kw))
        out[f"tiff_rgb_tiles_{cname}.tif"] = ("tiff", tiff_file(
            small, 8, 2, tile=(16, 16), compression=num))
        out[f"tiff_rgb_planar_{cname}.tif"] = ("tiff", tiff_file(
            small, 8, 2, planar=2, compression=num))
        out[f"tiff_grey16_be_{cname}.tif"] = ("tiff", tiff_file(
            samples["grey16"][0], 16, 1, order=">", compression=num))
    runs = np.repeat(rng.integers(0, 4, (20, 3)) * 60, [12, 2, 9], axis=1)
    out["tiff_grey8_zstd_rle_literals.tif"] = ("tiff", tiff_file(
        runs[..., None].astype(np.uint8), 8, 1, compression=50000,
        raw_strips=[zstd_runs_frame(runs.astype(np.uint8).tobytes())]))
    out["tiff_grey8_zstd_level19.tif"] = ("tiff", tiff_file(
        samples["grey8"][0], 8, 1, compression=50000, raw_strips=[
            __import__("zstandard").ZstdCompressor(level=19).compress(
                samples["grey8"][0].tobytes())]))
    # YCbCr through libtiff's RGBA path
    ycc = smooth_image(rng, 23, 19, 20.0)
    for hs, vs in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
        out[f"tiff_ycbcr{hs}{vs}_lzw.tif"] = ("tiff", ycbcr_tiff(
            ycc, hs, vs, 5, rows_per_strip=8))
    for cname, num in (("deflate", 8), ("packbits", 32773),
                       ("lzma", 34925), ("zstd", 50000)):
        out[f"tiff_ycbcr22_{cname}.tif"] = ("tiff", ycbcr_tiff(
            ycc, 2, 2, num, rows_per_strip=8))
    for (hs, vs), kw, tag in (
            ((2, 2), dict(tile=(16, 16)), "tiles"),
            ((4, 4), dict(tile=(16, 16)), "tiles"),
            ((4, 4), dict(rows_per_strip=5), "strips5"),
            ((4, 2), dict(rows_per_strip=4, order=">"), "be"),
            ((1, 1), dict(planar=2, rows_per_strip=8), "planar"),
            ((2, 2), dict(rows_per_strip=4, predictor=2), "predictor2"),
            ((2, 1), dict(rows_per_strip=4, predictor=2), "predictor2"),
            ((2, 2), dict(rows_per_strip=8, extra_tags=[(274, 3, [6])]),
             "orientation6"),
            ((2, 1), dict(extra_tags=[
                (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
                (529, 5, [2126, 10000, 7152, 10000, 722, 10000])]),
             "bt709_studio")):
        comp = 8 if kw.get("planar") or kw.get("predictor") else 5
        out[f"tiff_ycbcr{hs}{vs}_{tag}.tif"] = ("tiff", ycbcr_tiff(
            ycc, hs, vs, comp, **kw))
    # Pillow's own files
    im = PILImage.fromarray(smooth_image(rng, 9, 14, 10.0))
    for mode in ("L", "RGB", "CMYK", "YCbCr"):
        out[f"tiff_pillow_{mode.lower()}_jpeg.tif"] = ("tiff", _pillow(
            im.convert(mode), "TIFF", compression="jpeg"))
    for mode in ("1", "L", "RGB", "RGBA", "I;16", "YCbCr"):
        m = im.convert(mode) if mode != "I;16" else \
            im.convert("L").convert(mode)
        for comp in ("lzma", "zstd"):
            key = mode.replace(";", "").lower()
            out[f"tiff_pillow_{key}_{comp}.tif"] = ("tiff", _pillow(
                m, "TIFF", compression=comp))
    for comp in ("tiff_ccitt", "group3", "group4"):
        out[f"tiff_pillow_1_{comp}.tif"] = ("tiff", _pillow(
            im.convert("1"), "TIFF", compression=comp))
    return out


def webp_fixtures(rng, texels: np.ndarray) -> dict:
    """Lossy WebP (sizes that are not multiples of 16, with and without
    alpha, segment, filter, sharpness and partition settings, ALPH raw
    and VP8L-coded under each filter), lossless WebP (natural images,
    palettes of 2, 4, 16 and 256 colours, colour caches, exact and near
    lossless), animations, and the texels as the 1024x1024 lossy file at
    quality 90 and a lossless crop."""
    out = {}
    for h, w in ((13, 11), (17, 33), (64, 48), (1, 1), (5, 100)):
        im = smooth_image(rng, h, w, 8.0)
        out[f"webp_lossy_{w}x{h}.webp"] = ("webp", webp_encode(im, 80.0))
    im = smooth_image(rng, 45, 61, 14.0)
    for name, cfg in (
            ("simple_filter", dict(filter_type=0)),
            ("simple_filter_sharpness7", dict(filter_type=0,
                                              filter_sharpness=7)),
            ("strong_filter_sharpness3", dict(filter_strength=100,
                                              filter_sharpness=3)),
            ("no_filter", dict(filter_strength=0)),
            ("autofilter", dict(autofilter=1)),
            ("one_segment", dict(segments=1)),
            ("two_segments", dict(segments=2, sns_strength=100)),
            ("four_partitions", dict(partitions=2)),
            ("eight_partitions", dict(partitions=3, method=6)),
            ("quality5", dict(preprocessing=4)),
            ("quality100", dict(sns_strength=0)),
            ("method0", dict(method=0)),
            ("sharp_yuv", dict(use_sharp_yuv=1))):
        quality = {"quality5": 5.0, "quality100": 100.0}.get(name, 75.0)
        out[f"webp_lossy_{name}.webp"] = ("webp", webp_encode(
            im, quality, **cfg))
    noise = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    out["webp_lossy_noise.webp"] = ("webp", webp_encode(noise, 60.0))
    rgba = np.concatenate([im, rng.integers(0, 256, im.shape[:2] + (1,))
                           .astype(np.uint8)], axis=2)
    rgba[10:20, :, 3] = 0
    for name, cfg in (("alpha", {}), ("alpha_raw", dict(alpha_compression=0)),
                      ("alpha_best_filter", dict(alpha_filtering=2)),
                      ("alpha_quantised", dict(alpha_quality=30))):
        out[f"webp_lossy_{name}.webp"] = ("webp", webp_encode(
            rgba, 75.0, **cfg))
    vp8 = riff_chunks(webp_encode(im, 75.0))[b"VP8 "]
    ramp = np.add.outer(np.arange(45) * 3, np.arange(61) * 2).astype(
        np.uint8)
    for method in range(4):
        for lossless in (False, True):
            tag = "vp8l" if lossless else "raw"
            out[f"webp_lossy_alph_{tag}_filter{method}.webp"] = (
                "webp", riff(vp8x(61, 45, 0x10),
                             alph_chunk(ramp, method, lossless),
                             chunk(b"VP8 ", vp8)))
    nat = smooth_image(rng, 37, 29, 6.0)
    for name, cfg in (("method0", dict(method=0)), ("method6", dict(
            method=6)), ("quality0", dict(method=4)), ("exact", dict(
            exact=1)), ("near_lossless", dict(near_lossless=40)),
            ("graph_hint", dict(image_hint=3))):
        quality = 0.0 if name == "quality0" else 100.0
        out[f"webp_lossless_{name}.webp"] = ("webp", webp_encode(
            nat, quality, lossless=1, **cfg))
    out["webp_lossless_alpha.webp"] = ("webp", webp_encode(
        rgba, 90.0, lossless=1))
    for colours in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
        idx = rng.integers(0, colours, (23, 35))
        idx[:, ::3] = idx[:, :1]           # runs for the backward references
        out[f"webp_lossless_palette{colours}.webp"] = ("webp", webp_encode(
            pal[idx], 100.0, lossless=1, method=6))
    tiles = np.tile(smooth_image(rng, 8, 8, 30.0), (6, 7, 1))
    out["webp_lossless_repeats.webp"] = ("webp", webp_encode(
        tiles, 100.0, lossless=1, method=6))
    frames = [PILImage.fromarray(smooth_image(rng, 30, 40, 9.0))
              for _ in range(3)]
    for lossless in (False, True):
        tag = "lossless" if lossless else "lossy"
        out[f"webp_animated_{tag}.webp"] = ("webp", _pillow(
            frames[0], "WEBP", save_all=True, append_images=frames[1:],
            lossless=lossless, duration=40))
    frame = riff_chunks(webp_encode(smooth_image(rng, 9, 12, 9.0), 100.0,
                                    lossless=1))[b"VP8L"]
    anmf = (bytes((1, 0, 0, 2, 0, 0)) + (11).to_bytes(3, "little")
            + (8).to_bytes(3, "little") + (40).to_bytes(3, "little")
            + b"\x00")
    out["webp_animated_offset_frame.webp"] = ("webp", riff(
        vp8x(20, 16, 0x12), chunk(b"ANIM", bytes(6)),
        chunk(b"ANMF", anmf + chunk(b"VP8L", frame))))
    out[WEBP_BIG] = ("webp", _pillow(PILImage.fromarray(texels), "WEBP",
                                     quality=90))
    crop = texels[:WEBP_CROP, :WEBP_CROP]
    out[WEBP_CROP_NAME] = ("webp", _pillow(PILImage.fromarray(crop), "WEBP",
                                           lossless=True))
    return out



# ---------------------------------------------------------------- DDS

# DDS_PIXELFORMAT flags
DDS_ALPHAPIXELS, DDS_FOURCC, DDS_PALETTE8, DDS_RGB, DDS_LUMINANCE = (
    0x1, 0x4, 0x20, 0x40, 0x20000)


def dds_file(width: int, height: int, body: bytes, *, pfflags=DDS_FOURCC,
             fourcc=b"", bitcount=0, masks=(0, 0, 0, 0), dxgi=None,
             mipmaps=0, cube=False, array_size=1) -> bytes:
    """A DDS file: the 124-byte header (and the DX10 one where dxgi is
    given), then body."""
    flags = 0x1007 | (0x20000 if mipmaps else 0)
    caps = 0x1000 | (0x400008 if mipmaps else 0) | (0x8 if cube else 0)
    head = b"DDS " + struct.pack("<7I", 124, flags, height, width, 0, 0,
                                 mipmaps) + bytes(44)
    head += struct.pack("<2I4sI4I", 32, pfflags, fourcc.ljust(4, b"\0"),
                        bitcount, *masks)
    head += struct.pack("<5I", caps, 0xFE00 if cube else 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, array_size, 0)
    return head + body


def _bits(fields) -> np.ndarray:
    """[(values [n], bits)] -> the fields packed least significant bit
    first into [n, 16] bytes, one 128-bit block a row."""
    rows = np.concatenate([(np.asarray(v, np.uint32)[:, None]
                            >> np.arange(n, dtype=np.uint32)) & 1
                           for v, n in fields], axis=1).astype(np.uint8)
    assert rows.shape[1] == 128
    return np.packbits(rows, axis=1, bitorder="little")


def bc7_mode6(texels: np.ndarray) -> bytes:
    """The texels [H, W, 3] u8 as BC7 mode 6 blocks (edges replicated to
    whole blocks): each block's endpoints its own minimum (p-bit 0) and
    maximum (p-bit 1) per channel, alpha opaque, and each pixel the index
    of the nearest of the 16 colours between them, endpoints swapped where
    the anchor's index would need its fourth bit."""
    h, w = texels.shape[:2]
    px = np.pad(texels, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
    hb, wb = px.shape[0] // 4, px.shape[1] // 4
    blocks = px.reshape(hb, 4, wb, 4, 3).transpose(0, 2, 1, 3, 4).reshape(
        -1, 16, 3).astype(np.int32)
    lo, hi = blocks.min(1) >> 1, blocks.max(1) >> 1      # 7-bit endpoints
    e0, e1 = lo << 1, hi << 1 | 1
    wt = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                   64])
    pal = ((64 - wt)[None, :, None] * e0[:, None] + wt[None, :, None]
           * e1[:, None] + 32) >> 6                       # [n, 16, 3]
    idx = ((blocks[:, :, None] - pal[:, None]) ** 2).sum(-1).argmin(-1)
    swap = idx[:, 0] >= 8
    lo, hi = np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)
    idx = np.where(swap[:, None], 15 - idx, idx)
    n = len(blocks)
    fields = [(np.full(n, 64), 7)]
    for c in range(3):
        fields += [(lo[:, c], 7), (hi[:, c], 7)]
    fields += [(np.full(n, 127), 7), (np.full(n, 127), 7),
               (swap.astype(int), 1), (1 - swap, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    return dds_file(w, h, _bits(fields).tobytes(), fourcc=b"DX10", dxgi=98)


def dds_fixtures(rng) -> dict:
    """DDS files of every kind Pillow reads: Pillow's own (DXT1, DXT3,
    DXT5, BC2, BC3, BC5, L, LA, RGB, RGBA), and seeded random blocks of
    DXT1 in both colour modes, DXT5 in both alpha modes, BC4 (ATI1, BC4U),
    BC5 (ATI2, BC5U, BC5S), BC6H UF16 and SF16 in each of the 14 modes and
    the reserved ones, BC7 in each mode, without one and as sRGB, the DX10
    forms of BC1 to BC5 and R8G8B8A8, uncompressed RGB masks at 16, 24 and
    32 bits (one mask zero), an 8-bit palette, the crops of 1x1, 5x3 and
    13x9 images, and a file with mipmaps, a cube map and a DX10 array,
    whose first surface is the image."""
    out = {}

    def blocks(n, size=16):
        return rng.integers(0, 256, (n, size), dtype=np.uint8)

    im = PILImage.fromarray(smooth_image(rng, 10, 14, 12.0))
    rgba = im.convert("RGBA")
    rgba.putalpha(PILImage.fromarray(rng.integers(0, 256, (10, 14)).astype(
        np.uint8)))
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"):
        src = im if fmt == "BC5" else rgba
        out[f"dds_pillow_{fmt.lower()}.dds"] = ("dds", _pillow(
            src, "DDS", pixel_format=fmt))
    for mode in ("L", "LA", "RGB", "RGBA"):
        src = rgba if mode == "RGBA" else im.convert(mode)
        out[f"dds_pillow_{mode.lower()}.dds"] = ("dds", _pillow(src, "DDS"))
    # BC1 in four-colour (c0 > c1, the first block's endpoints (10, 20, 3)
    # and (3, 50, 30)) and three-colour mode (c0 <= c1, one block c0 = c1)
    b = blocks(4, 8)
    c = b[:, :4].copy().view("<u2")
    c.sort(axis=1)
    four, three = c[:, ::-1].copy(), c.copy()
    four[0] = (10 << 11 | 20 << 5 | 3, 3 << 11 | 50 << 5 | 30)
    three[0, 1] = three[0, 0]
    for name, ends in (("four_colour", four), ("three_colour", three)):
        b[:, :4] = ends.view(np.uint8)
        out[f"dds_dxt1_{name}.dds"] = ("dds", dds_file(
            8, 8, b.tobytes(), fourcc=b"DXT1"))
    b = blocks(4)
    a = np.sort(b[:, :2], axis=1)
    for name, ends in (("alpha8", a[:, ::-1]), ("alpha6", a)):
        b[:, :2] = ends
        out[f"dds_dxt5_{name}.dds"] = ("dds", dds_file(
            8, 8, b.tobytes(), fourcc=b"DXT5"))
    for fourcc in (b"ATI1", b"BC4U"):
        out[f"dds_bc4_{fourcc.decode().lower()}.dds"] = ("dds", dds_file(
            12, 8, blocks(6, 8).tobytes(), fourcc=fourcc))
    for fourcc in (b"ATI2", b"BC5U", b"BC5S"):
        out[f"dds_bc5_{fourcc.decode().lower()}.dds"] = ("dds", dds_file(
            12, 8, blocks(6).tobytes(), fourcc=fourcc))
    # BC6H: the 14 modes, the four reserved ones, two random blocks
    modes = [0, 1] + [k << 2 | 2 for k in range(8)] + [
        k << 2 | 3 for k in range(8)]
    for dxgi, name in ((95, "uf16"), (96, "sf16")):
        b = blocks(20)
        for k, mode in enumerate(modes):    # 2 or 5 mode bits
            keep = 0xFC if mode < 2 else 0xE0
            b[k, 0] = (b[k, 0] & keep) | mode
        out[f"dds_bc6h_{name}.dds"] = ("dds", dds_file(
            20, 16, b.tobytes(), fourcc=b"DX10", dxgi=dxgi))
    for mode in range(8):
        b = blocks(16)
        b[:, 0] = (b[:, 0] & ~np.uint8((2 << mode) - 1)) | (1 << mode)
        out[f"dds_bc7_mode{mode}.dds"] = ("dds", dds_file(
            16, 16, b.tobytes(), fourcc=b"DX10", dxgi=98))
    b = blocks(2)
    b[0, 0] = 0
    out["dds_bc7_no_mode.dds"] = ("dds", dds_file(8, 4, b.tobytes(),
                                                  fourcc=b"DX10", dxgi=98))
    out["dds_bc7_srgb.dds"] = ("dds", dds_file(
        12, 8, blocks(6).tobytes(), fourcc=b"DX10", dxgi=99))
    for kind, codes in ((1, (70, 71)), (2, (73, 74)), (3, (76, 77)),
                        (4, (79, 80)), (5, (82, 83, 84))):
        for dxgi, form in zip(codes, ("typeless", "unorm", "snorm")):
            out[f"dds_dx10_bc{kind}_{form}.dds"] = ("dds", dds_file(
                8, 8, blocks(4, 8 if kind in (1, 4) else 16).tobytes(),
                fourcc=b"DX10", dxgi=dxgi))
    for dxgi, form in ((27, "typeless"), (28, "unorm"), (29, "srgb")):
        out[f"dds_dx10_r8g8b8a8_{form}.dds"] = ("dds", dds_file(
            5, 3, blocks(15, 4).tobytes(), fourcc=b"DX10", dxgi=dxgi))
    rgb_masks = {   # name: (bitcount, masks r, g, b, a)
        "rgb16_565": (16, (0xF800, 0x7E0, 0x1F, 0)),
        "rgb16_1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
        "rgb16_4444": (16, (0xF00, 0xF0, 0xF, 0xF000)),
        "rgb24": (24, (0xFF0000, 0xFF00, 0xFF, 0)),
        "rgb32_a8r8g8b8": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "rgb32_x8r8g8b8": (32, (0xFF0000, 0xFF00, 0xFF, 0)),
        "rgb32_a8b8g8r8": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
        "rgb32_a2r10g10b10": (32, (0x3FF00000, 0xFFC00, 0x3FF,
                                   0xC0000000)),
        "rgb32_zero_mask": (32, (0xFF0000, 0, 0xFF, 0))}
    for name, (bits, masks) in rgb_masks.items():
        out[f"dds_{name}.dds"] = ("dds", dds_file(
            7, 5, blocks(35, bits // 8).tobytes(),
            pfflags=DDS_RGB | (DDS_ALPHAPIXELS if masks[3] else 0),
            bitcount=bits, masks=masks))
    out["dds_palette8.dds"] = ("dds", dds_file(
        7, 5, blocks(64).tobytes() + rng.integers(0, 256, 35).astype(
            np.uint8).tobytes(), pfflags=DDS_PALETTE8, bitcount=8))
    # shapes: crops of the block grid, and surfaces past the first
    out["dds_dxt1_1x1.dds"] = ("dds", dds_file(1, 1, blocks(1, 8).tobytes(),
                                               fourcc=b"DXT1"))
    out["dds_dxt5_5x3.dds"] = ("dds", dds_file(5, 3, blocks(2).tobytes(),
                                               fourcc=b"DXT5"))
    out["dds_bc7_13x9.dds"] = ("dds", dds_file(
        13, 9, blocks(12).tobytes(), fourcc=b"DX10", dxgi=98))
    out["dds_dxt1_mipmaps.dds"] = ("dds", dds_file(
        16, 16, blocks(16 + 4 + 1 + 1 + 1, 8).tobytes(), fourcc=b"DXT1",
        mipmaps=5))
    out["dds_dxt5_cube.dds"] = ("dds", dds_file(
        8, 8, blocks(6 * 4).tobytes(), fourcc=b"DXT5", cube=True))
    out["dds_dx10_bc7_array2.dds"] = ("dds", dds_file(
        8, 8, blocks(2 * 4).tobytes(), fourcc=b"DX10", dxgi=98,
        array_size=2))
    return out

# descriptor bits 4 and 5 -> the corner of the first pixel
ORIENTATIONS = {0x00: "bottom_left", 0x10: "bottom_right", 0x20: "top_left",
                0x30: "top_right"}


def tga_fixtures(rng) -> dict:
    """Every TGA kind Pillow reads in all four orientations (raw), run
    length with packets across row ends, Pillow's own files, an ID field
    and grey through a colour map."""
    h, w = 5, 7
    cmap24 = rng.integers(0, 256, (12, 3), dtype=np.uint8)
    cmap16 = rng.integers(0, 1 << 16, 12).astype("<u2")
    idx = rng.integers(0, 16, (h, w)).astype(np.uint8)  # past the map too
    kinds = {   # name: (image type, depth, pixels [h, w, bytes], map, bits)
        "cmap24": (1, 8, idx[..., None], cmap24[:, ::-1].tobytes(), 24),
        "cmap16": (1, 8, idx[..., None], cmap16.tobytes(), 16),
        "rgb16": (2, 16, rng.integers(0, 1 << 16, (h, w)).astype(
            "<u2").view(np.uint8).reshape(h, w, 2), b"", 0),
        "rgb24": (2, 24, rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                  b"", 0),
        "rgba32": (2, 32, rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
                   b"", 0),
        "grey8": (3, 8, rng.integers(0, 256, (h, w, 1), dtype=np.uint8),
                  b"", 0),
        "grey_alpha16": (3, 16, rng.integers(0, 256, (h, w, 2),
                                             dtype=np.uint8), b"", 0),
    }
    out = {}
    for name, (itype, depth, px, cmap, bits) in kinds.items():
        for flags, corner in ORIENTATIONS.items():
            out[f"tga_{name}_{corner}.tga"] = ("tga", tga_file(
                w, h, itype, depth, px.tobytes(), cmap, 3 if cmap else 0,
                bits, flags))
        # few distinct values, so that runs occur
        few = px[rng.integers(0, 2, (h, w)), rng.integers(0, 2, (h, w))]
        flags = list(ORIENTATIONS)[len(out) % 4]
        out[f"tga_{name}_rle_{ORIENTATIONS[flags]}.tga"] = ("tga", tga_file(
            w, h, itype | 8, depth, tga_rle_rows(few, rng), cmap,
            3 if cmap else 0, bits, flags))
    bits1 = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8), axis=1)
    for flags, corner in ORIENTATIONS.items():
        out[f"tga_grey1_{corner}.tga"] = ("tga", tga_file(
            w, h, 3, 1, bits1.tobytes(), descriptor=flags))
    out["tga_rgb24_image_id.tga"] = ("tga", tga_file(
        w, h, 2, 24, kinds["rgb24"][2].tobytes(), descriptor=0x20,
        image_id=b"a 23-byte image ID here"))
    out["tga_grey8_colour_map.tga"] = ("tga", tga_file(
        w, h, 3, 8, idx.tobytes(), cmap24[:, ::-1].tobytes(), 2, 24))
    rgb = PILImage.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1"):
        for rle in (False, True):
            if mode == "1" and rle:
                continue          # Pillow writes it, but cannot read it
            out[f"tga_pillow_{mode.lower()}{'_rle' if rle else ''}.tga"] = (
                "tga", _pillow(rgb.convert(mode), "TGA", rle=rle))
    return out


def pnm_fixtures(rng) -> dict:
    """P1 to P6: plain text with comments and odd whitespace, odd maxvals,
    16-bit samples (Pillow's "I" saturation and 16-bit rounding), and the
    files Pillow writes."""
    h, w = 5, 7
    out = {}

    def plain(magic, maxval, values, per_line):
        head = f"{magic}\n# a comment\n{w} #width\n  {h}\n"
        if maxval:
            head += f"{maxval}\n"
        flat = [str(int(v)) for v in values.reshape(-1)]
        lines = [" ".join(flat[i:i + per_line])
                 for i in range(0, len(flat), per_line)]
        body = "\n".join(f"{ln}\t# row {i}" if i % 2 else ln
                         for i, ln in enumerate(lines))
        return (head + body + "\n").encode()

    bits = rng.integers(0, 2, (h, w))
    out["pnm_p1.pbm"] = ("pnm", plain("P1", 0, bits, 5))
    out["pnm_p1_packed.pbm"] = ("pnm", b"P1 7 5\n" + "".join(
        map(str, bits.reshape(-1))).encode())
    for maxval in (15, 255, 1000, 65535):
        v = rng.integers(0, maxval + 1, (h, w))
        v.reshape(-1)[:2] = (7, maxval // 2)     # 7 at 15 -> 119; 500 / 1000
        out[f"pnm_p2_maxval{maxval}.pgm"] = ("pnm", plain("P2", maxval, v,
                                                          6))
        out[f"pnm_p3_maxval{maxval}.ppm"] = ("pnm", plain(
            "P3", maxval, rng.integers(0, maxval + 1, (h, w, 3)), 9))
    out["pnm_p4.pbm"] = ("pnm", b"P4\n# comment\n7 5\n" + np.packbits(
        bits.astype(np.uint8), axis=1).tobytes())
    for maxval in (1, 15, 255, 1000, 65535):
        big = maxval > 255
        v = rng.integers(0, maxval + 1, (h, w))
        rgb = rng.integers(0, maxval + 1, (h, w, 3))
        if maxval == 15:
            v.reshape(-1)[:3] = (7, 16, 255)        # past maxval: saturate
        if maxval == 65535:
            rgb.reshape(-1)[:3] = (1000, 32767, 32768)   # 1000 -> 4
        dt = ">u2" if big else np.uint8
        p5 = f"P5 {w} {h} {maxval}\n".encode() + v.astype(dt).tobytes()
        p6 = f"P6\n{w}\n{h}\n{maxval}\r".encode() + rgb.astype(dt).tobytes()
        out[f"pnm_p5_maxval{maxval}.pgm"] = ("pnm", p5)
        out[f"pnm_p6_maxval{maxval}.ppm"] = ("pnm", p6)
    im = PILImage.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    out["pnm_pillow_p4.pbm"] = ("pnm", _pillow(im.convert("1"), "PPM"))
    out["pnm_pillow_p5.pgm"] = ("pnm", _pillow(im.convert("L"), "PPM"))
    out["pnm_pillow_p6.ppm"] = ("pnm", _pillow(im, "PPM"))
    out["pnm_pillow_p5_16bit.pgm"] = ("pnm", _pillow(PILImage.fromarray(
        rng.integers(0, 600, (h, w)).astype(np.uint16)), "PPM"))
    return out


def gif_fixtures(rng) -> dict:
    """Pillow's plain and interlaced GIFs; global and local tables, an
    offset frame with and without a transparent index, a frame past the
    screen, no table, the identity ramp as the table, indices past the
    table, clear codes, a full code table, extensions before the frame."""
    h, w = 9, 11
    out = {}
    im = PILImage.fromarray(smooth_image(rng, 17, 19, 20.0))
    out["gif_pillow.gif"] = ("gif", _pillow(im, "GIF", interlace=False))
    out["gif_pillow_interlaced.gif"] = ("gif", _pillow(im, "GIF"))
    pal = rng.integers(0, 256, (8, 3))
    local = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 8, (h, w))
    out["gif_global_table.gif"] = ("gif", gif_file((w, h), idx, pal))
    out["gif_local_table.gif"] = ("gif", gif_file(
        (w, h), rng.integers(0, 16, (h, w)), pal, local))
    out["gif_interlaced.gif"] = ("gif", gif_file((w, h), idx, pal,
                                                 interlace=True))
    small = rng.integers(0, 8, (5, 6))
    out["gif_offset.gif"] = ("gif", gif_file((w, h), small, pal,
                                             offset=(3, 2)))
    out["gif_offset_transparent.gif"] = ("gif", gif_file(
        (w, h), small, pal, offset=(4, 1), transparent=5, interlace=True))
    out["gif_past_the_screen.gif"] = ("gif", gif_file((5, 4), small, pal,
                                                      offset=(2, 3)))
    out["gif_no_table.gif"] = ("gif", gif_file((w, h), rng.integers(
        0, 200, (h, w)), min_size=8))
    ramp = np.repeat(np.arange(8)[:, None], 3, axis=1)
    out["gif_ramp_table.gif"] = ("gif", gif_file((w, h), rng.integers(
        0, 32, (h, w)), ramp, min_size=5))
    out["gif_local_ramp_table.gif"] = ("gif", gif_file(
        (w, h), rng.integers(0, 16, (h, w)), pal, ramp, min_size=4))
    out["gif_index_past_table.gif"] = ("gif", gif_file(
        (w, h), rng.integers(0, 16, (h, w)), pal[:3], min_size=4))
    out["gif_clear_codes.gif"] = ("gif", gif_file(
        (w, h), idx, pal, clear_every=7))
    full = rng.integers(0, 4, (64, 80))                # the table fills up
    out["gif_full_code_table.gif"] = ("gif", gif_file((80, 64), full,
                                                      pal[:4]))
    out["gif_extensions.gif"] = ("gif", gif_file(
        (w, h), idx, pal, transparent=2, extensions=(
            b"!\xfe\x05hello\x03abc\x00"
            b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")))
    return out


def psd_fixtures(rng) -> dict:
    """Every colour mode Pillow converts, raw and PackBits; RGB with a
    fifth channel, indexed without a table, and image resources and a
    layer section to skip."""
    h, w = 5, 9
    out = {}

    def planes(n, top=256):
        return [rng.integers(0, top, (h, w), dtype=np.uint8)
                for _ in range(n)]

    table = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    resource = (b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00" +
                struct.pack(">I", 3) + b"abc\x00" + b"8BIM" +
                struct.pack(">H", 1006) + b"\x03abc" + struct.pack(">I", 4)
                + b"abcd")
    layers = struct.pack(">I", 2) + b"\x00\x00\x00\x00\x00\x00"
    modes = {   # name: (colour mode, depth, planes, colour data)
        "bitmap": (0, 1, [np.packbits(rng.integers(0, 2, (h, w)).astype(
            np.uint8), axis=1)], b""),
        "grey": (1, 8, planes(1), b""),
        "indexed": (2, 8, planes(1), table),
        "rgb": (3, 8, planes(3), b""),
        "rgba": (3, 8, planes(4), b""),
        "cmyk": (4, 8, planes(4), b""),
        "multichannel": (7, 8, planes(3), b""),
        "duotone": (8, 8, planes(1), b"duotone data"),
    }
    for name, (mode, depth, ps, colour_data) in modes.items():
        for rle in (False, True):
            # PackBits finds runs where the planes repeat bytes
            ps_ = [np.repeat(p[:, ::2], 2, axis=1)[:, :p.shape[1]]
                   if rle else p for p in ps]
            out[f"psd_{name}_{'rle' if rle else 'raw'}.psd"] = (
                "psd", psd_file(w, h, mode, depth, ps_, rle, rng,
                                colour_data, resources=resource if rle
                                else b"", layers=layers if rle else b""))
    out["psd_grey_in_bitmap_mode.psd"] = ("psd", psd_file(
        w, h, 0, 8, planes(1)))
    out["psd_rgb_5_channels.psd"] = ("psd", psd_file(w, h, 3, 8, planes(5),
                                                     True, rng))
    out["psd_indexed_no_table.psd"] = ("psd", psd_file(w, h, 2, 8,
                                                       planes(1)))
    return out


# ------------------------------------------------ SGI, PCX, DCX, QOI, ICO,
# CUR, BLP, FTEX and Sun raster: the formats of model and game asset sets


def sgi_rle_row(values: np.ndarray, bpc: int, rng) -> bytes:
    """One channel of one row as SGI run-length packets of bpc-byte atoms,
    runs and copies of random lengths up to 127, then the zero
    terminator."""
    atom = ">u2" if bpc == 2 else "u1"
    out, i, n = [], 0, len(values)
    while i < n:
        run = 1
        while i + run < n and values[i + run] == values[i] and run < 127:
            run += 1
        if run > 1 and rng.random() < 0.8:
            out.append(np.array([run, values[i]], atom).tobytes())
            i += run
            continue
        k = int(min(n - i, rng.integers(1, 128)))
        out.append(np.array([0x80 | k], atom).tobytes()
                   + np.asarray(values[i:i + k], atom).tobytes())
        i += k
    return b"".join(out) + np.array([0], atom).tobytes()


def sgi_file(px: np.ndarray, bpc: int = 1, rle: bool = False, rng=None,
             dim: int | None = None) -> bytes:
    """An SGI file of px [h, w, z] (values below 256 ** bpc, row 0 the
    top): raw planes, or run-length rows (sgi_rle_row) after their start
    and length tables."""
    h, w, z = px.shape
    dim = dim or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHii", 474, int(rle), bpc, dim, w, h, z, 0,
                       256 ** bpc - 1).ljust(512, b"\0")
    rows = px[::-1]                               # the file's rows bottom-up
    if not rle:
        atom = ">u2" if bpc == 2 else "u1"
        return head + np.ascontiguousarray(
            rows.transpose(2, 0, 1)).astype(atom).tobytes()
    packed = [[sgi_rle_row(rows[y, :, c], bpc, rng) for y in range(h)]
              for c in range(z)]
    start, starts, lengths = 512 + 8 * h * z, [], []
    for chan in packed:
        for row in chan:
            starts.append(start)
            lengths.append(len(row))
            start += len(row)
    return (head + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths)
            + b"".join(row for chan in packed for row in chan))


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX run-length rows: runs of up to 63 bytes, single bytes as
    themselves unless their top two bits are set."""
    out = bytearray()
    for row in rows:
        i, n = 0, len(row)
        while i < n:
            run = 1
            while i + run < n and row[i + run] == row[i] and run < 63:
                run += 1
            if run > 1 or row[i] >= 0xC0:
                out += bytes((0xC0 | run, row[i]))
            else:
                out.append(row[i])
            i += run
    return bytes(out)


def pcx_file(w: int, h: int, bits: int, planes: int, rows: np.ndarray, *,
             version: int = 5, palette16=None, palette256=None,
             stride: int | None = None, origin=(0, 0)) -> bytes:
    """A PCX file: rows [h, planes * stride] (each row its planes one after
    another), run-length coded, and the 769-byte palette where given."""
    stride = stride or rows.shape[1] // planes
    pal16 = bytes(48) if palette16 is None else np.asarray(
        palette16, np.uint8).tobytes()
    x0, y0 = origin
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0,
                        x0 + w - 1, y0 + h - 1, 72, 72) + pal16
            + bytes((0, planes)) + struct.pack("<HH", stride, 1)
            + bytes(58))
    tail = b"" if palette256 is None else b"\x0c" + np.asarray(
        palette256, np.uint8).tobytes()
    return head + pcx_rle(np.asarray(rows, np.uint8)) + tail


def dcx_file(pages: list) -> bytes:
    """A DCX file of the PCX files `pages`."""
    at, table = 4 + 4 * (len(pages) + 1), []
    for page in pages:
        table.append(at)
        at += len(page)
    return (struct.pack(f"<{len(pages) + 2}I", 987654321, *table, 0)
            + b"".join(pages))


def dib_bytes(px: np.ndarray, bits: int, palette=None,
              and_mask: bool = True) -> bytes:
    """An icon or cursor entry's bitmap: a 40-byte header whose height is
    twice px's ([h, w] indices at 1, 4 or 8 bits with palette [k, 3], or
    [h, w, 3] RGB at 24 or 32 bits), rows bottom-up, then the AND mask."""
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    if bits <= 8:
        per = 8 // bits
        idx = np.zeros((h, -(-w // per) * per), np.uint8)
        idx[:, :w] = px
        packed = np.zeros((h, idx.shape[1] // per), np.uint8)
        for k in range(per):
            packed |= idx[:, k::per] << np.uint8(8 - bits * (k + 1))
        rows[:, :packed.shape[1]] = packed
    else:
        ch = bits // 8
        bgr = np.zeros((h, w, ch), np.uint8)
        bgr[..., :3] = px[..., ::-1]
        if ch == 4:
            bgr[..., 3] = 255
        rows[:, :w * ch] = bgr.reshape(h, -1)
    colours = 0 if palette is None else len(palette)
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0,
                       stride * h, 0, 0, colours, 0)
    pal = b"" if palette is None else np.concatenate(
        [np.asarray(palette, np.uint8)[:, ::-1],
         np.zeros((colours, 1), np.uint8)], axis=1).tobytes()
    mask = bytes((-(-w // 32) * 4) * h) if and_mask else b""
    return head + pal + rows[::-1].tobytes() + mask


def icon_file(entries: list, cursor: bool = False) -> bytes:
    """An ICO (or CUR) file of entries [(width byte, height byte, colour
    count, bits a pixel, data)], the data one after another."""
    at = 6 + 16 * len(entries)
    head = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    body = b""
    for wb, hb, ncol, bpp, data in entries:
        head += struct.pack("<BBBBHHII", wb, hb, ncol, 0, 1, bpp, len(data),
                            at + len(body))
        body += data
    return head + body


def ftex_file(w: int, h: int, fmt: int, body: bytes, *, count: int = 1,
              where: int | None = None, size: int | None = None) -> bytes:
    """An FTEX file: the header, one format entry and its mipmap."""
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<5i", 1, w, h, 1, count) + struct.pack(
        "<2i", fmt, where)
    return head.ljust(where, b"\0") + struct.pack(
        "<i", len(body) if size is None else size) + body


def sun_rle(data: bytes) -> bytes:
    """Sun raster run-length data: runs of 2 to 256 bytes as 0x80 n v, a
    single 0x80 as 0x80 0x00, other bytes as themselves."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < 256:
            run += 1
        if run > 2 or (run == 2 and data[i] == 0x80):
            out += bytes((0x80, run - 1, data[i]))
        elif data[i] == 0x80:
            out += b"\x80\x00"
            run = 1
        else:
            out.append(data[i])
            run = 1
        i += run
    return bytes(out)


def sun_file(w: int, h: int, depth: int, rows: np.ndarray, ftype: int = 1,
             palette=None, maptype: int = 1) -> bytes:
    """A Sun raster file of rows [h, row bytes] (padded to 16 bits, or
    Pillow's unpadded rows for run-length type 2) and an optional RGB
    colour map [k, 3] (stored as its planes)."""
    body = np.asarray(rows, np.uint8).tobytes()
    if ftype == 2:
        body = sun_rle(body)
    cmap = b"" if palette is None else np.ascontiguousarray(
        np.asarray(palette, np.uint8).T).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       maptype if cmap else 0, len(cmap)) + cmap + body


def blp_file(version: int, w: int, h: int, mip: bytes, *, compression=1,
             encoding=1, alpha=0, alpha_encoding=0, palette=None,
             jpeg_header: bytes | None = None) -> bytes:
    """A BLP1 or BLP2 file of one mipmap: BLP1 with a JPEG (compression 0,
    the stream split into jpeg_header and mip) or palette indices; BLP2 of
    encoding 1 (indices), 2 (DXT blocks, alpha_encoding 0, 1 or 7) or
    another; palette [256, 4] BGRA (zeros where None)."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                     encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding,
                                     alpha, alpha_encoding, 0, w, h)
    pal = bytes(1024) if palette is None else np.asarray(
        palette, np.uint8).tobytes()
    if jpeg_header is not None:
        pre = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        pre = pal
    at = len(head) + 128 + len(pre)
    return (head + struct.pack("<16I", at, *[0] * 15)
            + struct.pack("<16I", len(mip), *[0] * 15) + pre + mip)


def dxt_blocks(rng, n: int, kind: str) -> bytes:
    """n random DXT1 (8-byte) or DXT3 / DXT5 (16-byte) blocks, half of the
    DXT1 ones in three-colour mode (c0 <= c1)."""
    size = 8 if kind == "DXT1" else 16
    blk = rng.integers(0, 256, (n, size), dtype=np.uint8)
    if kind == "DXT1":
        c = blk[:, :4].copy().view("<u2")
        lo, hi = np.minimum(c[:, 0], c[:, 1]), np.maximum(c[:, 0], c[:, 1])
        three = rng.random(n) < 0.5
        c[:, 0] = np.where(three, lo, hi)
        c[:, 1] = np.where(three, hi, lo)
        blk[:, :4] = c.view(np.uint8).reshape(n, 4)
    return blk.tobytes()


def asset_fixtures(rng) -> dict:
    """Small SGI, PCX, DCX, QOI, ICO, CUR, BLP, FTEX and Sun raster files:
    Pillow's own (SGI raw, PCX in each mode it saves, QOI, ICO of bitmaps
    and of PNGs, BLP1 and BLP2 palettes) and hand-made ones of what Pillow
    does not write (SGI run-length at 8 and 16 bits, PCX's 1-bit planes,
    DCX, CUR, FTEX, Sun raster of each depth, type and run-length, BLP2
    DXT1 / DXT3 / DXT5 and BLP1 JPEG and palette)."""
    out = {}
    h, w = 5, 7
    img = PILImage.fromarray(smooth_image(rng, h, w, 30.0))
    rgba = img.convert("RGBA")
    rgba.putalpha(PILImage.fromarray(rng.integers(0, 256, (h, w)).astype(
        np.uint8)))
    out["sgi_pillow_rgb.sgi"] = ("sgi", _pillow(img, "SGI"))
    out["sgi_pillow_rgba16.sgi"] = ("sgi", _pillow(rgba, "SGI", bpc=2))
    few = rng.integers(0, 3, (h, w, 4)) * 100
    out["sgi_rgba_rle.sgi"] = ("sgi", sgi_file(few, 1, True, rng))
    out["sgi_grey16_rle.bw"] = ("sgi", sgi_file(
        (few[..., :1] * 257 + rng.integers(0, 2, (h, w, 1))), 2, True, rng))
    for mode in ("1", "L", "P", "RGB"):
        out[f"pcx_pillow_{mode.lower()}.pcx"] = ("pcx", _pillow(
            img.convert(mode), "PCX"))
    pal16 = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    for planes in (2, 4):
        rows = rng.integers(0, 4, (h, planes * 2), dtype=np.uint8) * 0x55
        out[f"pcx_1bit_{planes}planes.pcx"] = ("pcx", pcx_file(
            w, h, 1, planes, rows, version=2, palette16=pal16))
    page = _pillow(img, "PCX")
    out["dcx_two_pages.dcx"] = ("pcx", dcx_file([page, _pillow(
        img.convert("1"), "PCX")]))
    out["qoi_pillow_rgb.qoi"] = ("qoi", _pillow(img, "QOI"))
    out["qoi_pillow_rgba.qoi"] = ("qoi", _pillow(rgba, "QOI"))
    icon = PILImage.fromarray(smooth_image(rng, 8, 8, 30.0))
    out["ico_pillow_bmp.ico"] = ("ico", _pillow(
        icon, "ICO", sizes=[(8, 8), (4, 4)], bitmap_format="bmp"))
    out["ico_pillow_png.ico"] = ("ico", _pillow(
        icon.convert("RGBA"), "ICO", sizes=[(8, 8), (6, 6)]))
    idx = rng.integers(0, 16, (h, w), dtype=np.uint8)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    cur_big = dib_bytes(idx, 4, pal)
    out["cur_4bit.cur"] = ("ico", icon_file(
        [(3, 2, 16, 4, dib_bytes(idx[:2, :3], 4, pal)), (w, h, 16, 4,
                                                         cur_big)],
        cursor=True))
    out["blp1_pillow.blp"] = ("blp", _pillow(
        img.convert("P"), "BLP", blp_version="BLP1"))
    out["blp2_pillow.blp"] = ("blp", _pillow(img.convert("P"), "BLP"))
    bgra = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    for kind, enc in (("dxt1", 0), ("dxt3", 1), ("dxt5", 7)):
        out[f"blp2_{kind}_8x8.blp"] = ("blp", blp_file(
            2, 8, 8, dxt_blocks(rng, 4, kind.upper()), encoding=2,
            alpha=int(kind != "dxt1"), alpha_encoding=enc, palette=bgra))
    jpg = _pillow(img, "JPEG", quality=90)
    out["blp1_jpeg.blp"] = ("blp", blp_file(
        1, w, h, jpg[160:], compression=0, jpeg_header=jpg[:160]))
    out["blp1_palette.blp"] = ("blp", blp_file(
        1, w, h, idx.tobytes(), encoding=4, palette=bgra))
    bc1 = dxt_blocks(rng, 4, "DXT1")
    out["ftex_dxt1.ftc"] = ("ftex", ftex_file(7, 6, 0, bc1))
    out["ftex_rgb.ftu"] = ("ftex", ftex_file(
        w, h, 1, np.asarray(img).tobytes()))
    rgb = np.asarray(img)
    stride = (w * 3 + 1) // 2 * 2
    rows24 = np.zeros((h, stride), np.uint8)
    rows24[:, :w * 3] = rgb[..., ::-1].reshape(h, -1)
    out["sun_24bit.ras"] = ("sun", sun_file(w, h, 24, rows24))
    out["sun_32bit_rgb.ras"] = ("sun", sun_file(w, h, 32, np.concatenate(
        [np.zeros((h, w, 1), np.uint8), rgb], axis=2)[..., [1, 2, 3, 0]]
        .reshape(h, -1), ftype=3))
    out["sun_24bit_rle.ras"] = ("sun", sun_file(
        w, h, 24, (few[..., :3] // 2).astype(np.uint8)[..., ::-1].reshape(
            h, -1), ftype=2))
    out["sun_8bit_colour_map_rle.ras"] = ("sun", sun_file(
        w, h, 8, idx, ftype=2, palette=pal[:12]))
    bits1 = np.packbits(rng.integers(0, 2, (h, 16)).astype(np.uint8), axis=1)
    out["sun_1bit.ras"] = ("sun", sun_file(w, h, 1, bits1))
    out["sun_4bit.ras"] = ("sun", sun_file(w, h, 4, rng.integers(
        0, 256, (h, 4), dtype=np.uint8)))
    return out


# ---------------------------------------------------------------- JPEG 2000

# the chip path's files of BIG's texels (chip_smoke.py phase 18c), with a
# manifest of their own beside the fixtures'
J2K_CHIP_DIR = os.path.join(OUT, "j2k_chip")
J2K_CROP = 512
J2K_LOSSLESS = f"j2k_lossless_rpcl_tiles256_crop{J2K_CROP}.j2k"
JP2_LOSSY = "jp2_lossy_97_3layers_cb32_1024.jp2"
ICNS_JP2 = "icns_ic10_jp2_1024.icns"


def box(kind: bytes, body: bytes) -> bytes:
    """A JP2 box."""
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(codestream: bytes, *, ihdr=None, colr=((1, 16),), pclr=None,
             cmap=None, cdef=None, res=False, bpcc=None, brand=b"jp2 ",
             compat=(b"jp2 ",), before=(), inside=(), after=(),
             jp2h=True, jp2c=True, tail=()) -> bytes:
    """A JP2 file around a codestream: the signature, ftyp (brand and the
    compatibility list compat), the boxes before (raw bytes), jp2h (ihdr
    (height, width, components, bit-depth byte) from the SIZ by default,
    None's False leaves it out; colr boxes (1, enumcs) or (2, ICC bytes), or
    a colr box's raw body as bytes; pclr (entries [N, C] and each column's
    bit-depth byte); cmap [(component, type, column)]; cdef [(channel, type,
    association)]; res a resc box; then the boxes inside, raw) unless jp2h
    is False, the boxes after, jp2c unless jp2c is False, and the boxes of
    tail."""
    if ihdr is None:
        xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", codestream, 8)
        nc = struct.unpack_from(">H", codestream, 40)[0]
        ihdr = (ysiz - yo, xsiz - xo, nc, codestream[42])
    head = b""
    if ihdr is not False:
        head += box(b"ihdr", struct.pack(">IIHBBBB", *ihdr, 7, 0, 0))
    if bpcc is not None:
        head += box(b"bpcc", bytes(bpcc))
    for c in colr:
        if isinstance(c, bytes):
            head += box(b"colr", c)
            continue
        meth, what = c
        head += box(b"colr", struct.pack(">BBB", meth, 0, 0) + (
            struct.pack(">I", what) if meth == 1 else what))
    if pclr is not None:
        entries, depths = pclr
        entries = np.asarray(entries, np.uint8)
        head += box(b"pclr", struct.pack(">HB", *entries.shape)
                    + bytes(depths) + entries.tobytes())
    if cmap is not None:
        head += box(b"cmap", b"".join(struct.pack(">HBB", *c) for c in cmap))
    if cdef is not None:
        head += box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *c) for c in cdef))
    if res:
        head += box(b"res ", box(b"resc", struct.pack(">HHHHbb", 2835, 1,
                                                       2835, 1, 0, 0)))
    head += b"".join(inside)
    return (box(b"jP  ", b"\x0d\x0a\x87\x0a")
            + box(b"ftyp", brand + bytes(4) + b"".join(compat))
            + b"".join(before) + (box(b"jp2h", head) if jp2h else b"")
            + b"".join(after) + (box(b"jp2c", codestream) if jp2c else b"")
            + b"".join(tail))


def _marker_segments(data: bytes, pos: int):
    """(marker, start, end) of each marker segment from pos to a SOT or
    SOD marker (excluded)."""
    while True:
        m = struct.unpack_from(">H", data, pos)[0]
        if m in (0xFF90, 0xFF93):
            return
        n = struct.unpack_from(">H", data, pos + 2)[0]
        yield m, pos, pos + 2 + n
        pos += 2 + n


def packed_headers(codestream: bytes, where: str) -> bytes:
    """A codestream written with SOP and EPH markers rewritten with its
    packet headers (each to its EPH) moved into PPT markers of each
    tile-part ("ppt") or PPM markers of the main header ("ppm"); the SOP
    markers stay with the packet bodies."""
    main_end = codestream.index(b"\xff\x90")
    parts = []
    pos = main_end
    while codestream[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", codestream, pos + 6)[0]
        segs = list(_marker_segments(codestream, pos + 12))
        sod = segs[-1][2] if segs else pos + 12
        end = pos + psot
        body = codestream[sod + 2:end]
        headers, bodies = [], []
        starts = [i for i in range(len(body) - 5) if body[i:i + 4]
                  == b"\xff\x91\x00\x04"] + [len(body)]
        for a, b in zip(starts, starts[1:]):
            eph = body.index(b"\xff\x92", a + 6) + 2
            headers.append(body[a + 6:eph])
            bodies.append(body[a:a + 6] + body[eph:b])
        extra = b"".join(codestream[a:b] for _, a, b in segs)
        parts.append((codestream[pos:pos + 6], codestream[pos + 10:pos + 12],
                      extra, b"".join(headers), b"".join(bodies)))
        pos = end

    def chunks(data, first):
        return [data[i:i + first] for i in range(0, len(data), first)] or [
            b""]

    main = codestream[:main_end]
    if where == "ppm":
        stream = b"".join(struct.pack(">I", len(h)) + h
                          for _, _, _, h, _ in parts)
        main += b"".join(struct.pack(">HHB", 0xFF60, 3 + len(c), z) + c
                         for z, c in enumerate(chunks(stream, 60000)))
    out = [main]
    for sot, rest, extra, headers, bodies in parts:
        if where == "ppt":
            extra += b"".join(struct.pack(">HHB", 0xFF61, 3 + len(c), z) + c
                              for z, c in enumerate(chunks(headers, 60000))
                              if headers)
        psot = 12 + len(extra) + 2 + len(bodies)
        out.append(sot + struct.pack(">I", psot) + rest + extra + b"\xff\x93"
                   + bodies)
    return b"".join(out) + b"\xff\xd9"


def icns_rle(channel: bytes) -> bytes:
    """An ICNS run-length channel: runs of 3 to 130 equal bytes as 0x80 +
    n - 3 and the byte, the rest as literal packets of up to 128 bytes."""
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(channel):
        j = i
        while j < len(channel) and j - i < 130 and channel[j] == channel[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes((len(lit) - 1,)) + lit
                lit = bytearray()
            out += bytes((0x80 + j - i - 3, channel[i]))
            i = j
        else:
            lit.append(channel[i])
            i += 1
            if len(lit) == 128:
                out += bytes((127,)) + lit
                lit = bytearray()
    if lit:
        out += bytes((len(lit) - 1,)) + lit
    return bytes(out)


def icns_file(entries: list) -> bytes:
    """An ICNS file of (type, data) entries."""
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(px: np.ndarray, lead: bool = False) -> bytes:
    """An it32 / ih32 / il32 / is32 entry's data: each channel run-length
    coded (it32's 4-byte zero lead with lead)."""
    return (bytes(4) if lead else b"") + b"".join(
        icns_rle(px[..., c].tobytes()) for c in range(3))


def j2k_fixtures(rng) -> dict:
    """Small JPEG 2000 and ICNS files: Pillow's saves across its options;
    codestreams from OpenJPEG's own encoder (j2k_encoder.py) for what
    Pillow's save cannot set (each code-block style, ROI, POC, subsampled
    components, precisions 1 to 16, image and tile offsets, tile-parts);
    PPT and PPM forms of such a stream; JP2 boxes wrapped by hand (a pclr
    with repeated colours and its cmap, cdef, colr 12, 16, 17, 18, res);
    ICNS files of PNG, JP2 and run-length entries."""
    out = {}
    h, w = 5, 7
    rgb = smooth_image(rng, h, w, 25.0)
    im = PILImage.fromarray(rgb)

    def j2k(name, img, **kw):
        out[name] = ("j2k", _pillow(img, "JPEG2000", no_jp2=True, **kw))

    j2k("j2k_pillow_l_5x7.j2k", im.convert("L"))
    j2k("j2k_pillow_rgb_5x7.j2k", im)
    rgba = im.convert("RGBA")
    rgba.putalpha(PILImage.fromarray(rng.integers(0, 256, (h, w)).astype(
        np.uint8)))
    j2k("j2k_pillow_rgba_5x7.j2k", rgba)
    j2k("j2k_pillow_la_5x7.j2k", rgba.convert("LA"))
    i16 = PILImage.fromarray(rng.choice([0, 9, 200, 255, 256, 4000, 65535],
                                        (h, w)).astype(np.uint16))
    j2k("j2k_pillow_i16_5x7.j2k", i16)
    j2k("j2k_pillow_l_signed_5x7.j2k", im.convert("L"), signed=True)
    j2k("j2k_pillow_rgb_mct1_5x7.j2k", im, mct=1)
    big = PILImage.fromarray(smooth_image(rng, 13, 15, 25.0))
    j2k("j2k_pillow_97_13x15.j2k", big, irreversible=True, num_resolutions=3)
    j2k("j2k_pillow_97_layers_13x15.j2k", big, irreversible=True,
        num_resolutions=3, quality_layers=[60, 20, 5])
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        j2k(f"j2k_pillow_{prog.lower()}_13x15.j2k", big, progression=prog,
            num_resolutions=3, precinct_size=(8, 8), codeblock_size=(4, 4),
            quality_layers=[30, 10])
    j2k("j2k_pillow_tiles_11x13.j2k", PILImage.fromarray(
        smooth_image(rng, 11, 13, 25.0)), tile_size=(8, 8), num_resolutions=2)
    j2k("j2k_pillow_plt_comment_5x7.j2k", im, plt=True, comment="texels")
    out["jp2_pillow_rgb_5x7.jp2"] = ("jp2", _pillow(im, "JPEG2000"))
    out["jp2_pillow_l_97_13x15.jp2"] = ("jp2", _pillow(
        big.convert("L"), "JPEG2000", irreversible=True, num_resolutions=3))
    # OpenJPEG's encoder
    planes = [p.astype(np.int32) for p in np.moveaxis(
        smooth_image(rng, 9, 11, 20.0), 2, 0)]
    for style in STYLE:
        out[f"j2k_style_{style}_9x11.j2k"] = ("j2k", j2k_encode(
            planes, styles=[style], codeblock=(4, 4), layers=[2.5, 1.2]))
    out["j2k_style_all_97_9x11.j2k"] = ("j2k", j2k_encode(
        planes, styles=list(STYLE), codeblock=(4, 4),
        irreversible=True, layers=[2.5, 1.2]))
    out["j2k_roi_shift_9x11.j2k"] = ("j2k", j2k_encode(
        planes, roi=(0, 5), codeblock=(4, 4), layers=[2.5, 1.2]))
    out["j2k_poc_9x11.j2k"] = ("j2k", j2k_encode(
        planes, resolutions=3, layers=[2.5, 1.5, 1.2],
        pocs=[(0, 0, 2, 2, 3, "RLCP", 1), (1, 0, 3, 3, 3, "CPRL", 1)]))
    sub = [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]]
    out["j2k_subsampled_420_9x11.j2k"] = ("j2k", j2k_encode(
        sub, sampling=[(1, 1), (2, 2), (2, 2)], mct=False))
    out["jp2_subsampled_422_srgb_9x11.jp2"] = ("jp2", j2k_encode(
        [planes[0], planes[1][:, ::2], planes[2][:, ::2]],
        sampling=[(1, 1), (2, 1), (2, 1)], mct=False, jp2=True, colour=1))
    for prec, signed in ((1, False), (4, False), (12, False), (16, False),
                         (5, True), (13, True)):
        lo = -(1 << (prec - 1)) if signed else 0
        px = rng.integers(lo, lo + (1 << prec), (3, 5, 6))
        out[f"j2k_prec{prec}{'_signed' if signed else ''}_5x6.j2k"] = (
            "j2k", j2k_encode(list(px), precision=prec, signed=signed))
    out["j2k_grey_prec10_5x6.j2k"] = ("j2k", j2k_encode(
        [rng.integers(0, 1024, (5, 6))], precision=10))
    out["j2k_offsets_9x11.j2k"] = ("j2k", j2k_encode(
        planes, image_offset=(5, 3), tiles=(6, 5), tile_offset=(2, 1)))
    for flag in ("R", "C"):
        out[f"j2k_tile_parts_{flag}_9x11.j2k"] = ("j2k", j2k_encode(
            planes, tiles=(8, 8), tile_parts=flag, resolutions=2,
            layers=[2.5, 1.2]))
    marked = j2k_encode(planes, sop=True, eph=True, tiles=(8, 8),
                        resolutions=2, layers=[2.5, 1.2])
    out["j2k_sop_eph_9x11.j2k"] = ("j2k", marked)
    for where in ("ppt", "ppm"):
        out[f"j2k_{where}_9x11.j2k"] = ("j2k", packed_headers(marked, where))
    # JP2 boxes by hand
    idx = rng.integers(0, 6, (h, w))
    grey = j2k_encode([idx], precision=3)
    entries = rng.integers(0, 256, (6, 3))
    entries[4] = entries[1]                       # a repeated colour
    out["jp2_pclr_repeated_5x7.jp2"] = ("jp2", jp2_file(
        grey, pclr=(entries, (7, 7, 7)), cmap=[(0, 1, 0), (0, 1, 1),
                                               (0, 1, 2)]))
    out["jp2_pclr_rgba_5x7.jp2"] = ("jp2", jp2_file(
        grey, pclr=(np.concatenate([entries, np.full((6, 1), 255)], 1),
                    (7, 7, 7, 7)),
        cmap=[(0, 1, c) for c in range(4)]))
    rgb_cs = j2k_encode(planes)
    small = [p[:5, :6] for p in planes]
    out["jp2_cdef_alpha_first_5x6.jp2"] = ("jp2", jp2_file(
        j2k_encode(small + small[:1]),
        cdef=[(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]))
    cmyk = [rng.integers(0, 256, (5, 6)) for _ in range(4)]
    out["jp2_colr12_cmyk_5x6.jp2"] = ("jp2", jp2_file(
        j2k_encode(cmyk, mct=False), colr=((1, 12),)))
    out["jp2_colr16_res_9x11.jp2"] = ("jp2", jp2_file(rgb_cs, res=True))
    out["jp2_colr17_grey_9x11.jp2"] = ("jp2", jp2_file(
        j2k_encode(planes[:1]), colr=((1, 17),)))
    out["jp2_colr18_sycc_9x11.jp2"] = ("jp2", jp2_file(
        j2k_encode(planes, mct=False), colr=((1, 18),)))
    out["jp2_two_colr_9x11.jp2"] = ("jp2", jp2_file(
        rgb_cs, colr=((1, 16), (2, b"not read"))))
    # ICNS
    # icons of few colours in runs, so that the run-length entries are short
    icon = np.repeat(rng.integers(0, 4, (16, 4, 3)) * 80, 4, axis=1).astype(
        np.uint8)
    out["icns_is32_s8mk.icns"] = ("icns", icns_file([
        (b"is32", icns_rgb(icon)), (b"s8mk", icon[..., 0].tobytes())]))
    icon32 = np.repeat(np.repeat(icon, 2, axis=0), 2, axis=1)
    out["icns_il32_icp4_png.icns"] = ("icns", icns_file([
        (b"il32", icns_rgb(icon32)), (b"icp4", png_file(icon, 8, 2))]))
    icon128 = np.repeat(rng.integers(0, 4, (128, 1, 3)) * 80, 128,
                        axis=1).astype(np.uint8)
    out["icns_it32.icns"] = ("icns", icns_file([
        (b"it32", icns_rgb(icon128, lead=True))]))
    out["icns_icp5_jp2.icns"] = ("icns", icns_file([
        (b"is32", icns_rgb(icon)), (b"icp5", _pillow(
            PILImage.fromarray(icon32), "JPEG2000", irreversible=True,
            quality_layers=[40]))]))
    return out


def j2k_chip_files(texels: np.ndarray) -> dict:
    """The chip path's files of BIG's texels: their top-left 512x512 crop
    as a lossless J2K codestream (5/3, RPCL, 256x256 tiles, SOP / EPH),
    the texels as a lossy JP2 (9/7, ICT, three quality layers, 32x32
    code-blocks) and an ICNS whose ic10 entry is that JP2."""
    crop = texels[:J2K_CROP, :J2K_CROP]
    lossless = j2k_encode(list(np.moveaxis(crop, 2, 0)), mct=True,
                          progression="RPCL", tiles=(256, 256), sop=True,
                          eph=True)
    lossy = _pillow(PILImage.fromarray(texels), "JPEG2000",
                    irreversible=True, mct=1, quality_layers=[200, 80, 40],
                    codeblock_size=(32, 32))
    return {J2K_LOSSLESS: ("j2k", lossless), JP2_LOSSY: ("jp2", lossy),
            ICNS_JP2: ("icns", icns_file([(b"ic10", lossy)]))}


# ------------------------------------------------- Part 2, TIFF's tail, Lab

def marker_segment(marker: int, body: bytes) -> bytes:
    """A JPEG 2000 marker segment."""
    return struct.pack(">HH", marker, len(body) + 2) + body


def mct_segment(index: int, values, element: int = 0, array: int = 2,
                zmct: int = 0, ymct: int = 0) -> bytes:
    """An MCT marker (Part 2): record index, its values as element type 0-3
    (int16, int32, float32, float64), array type 0-2 (dependency,
    decorrelation, offset)."""
    fmt = (">h", ">i", ">f", ">d")[element]
    data = b"".join(struct.pack(fmt, v) for v in values)
    return marker_segment(0xFF74, struct.pack(
        ">HHH", zmct, element << 10 | array << 8 | index, ymct) + data)


def mcc_segment(index: int, n: int, deco: int = 0, offset: int = 0,
                reversible: bool = False, wide: bool = False,
                collections: int = 1, kind: int = 1) -> bytes:
    """An MCC marker (Part 2): collection index over components 0..n-1
    (two bytes a component index with wide), its decorrelation and offset
    MCT record indices (0: none)."""
    width = 2 if wide else 1

    def comps():
        return struct.pack(">H", n | (0x8000 if wide else 0)) + b"".join(
            j.to_bytes(width, "big") for j in range(n))

    body = struct.pack(">HBHH", 0, index, 0, collections)
    if collections:
        body += bytes((kind,)) + comps() + comps() + bytes(
            (int(reversible), offset, deco))
    return marker_segment(0xFF75, body)


def mco_segment(*stages: int) -> bytes:
    """An MCO marker (Part 2): the MCC collections applied, in order."""
    return marker_segment(0xFF77, bytes((len(stages),)) + bytes(stages))


def cbd_segment(*depths: int) -> bytes:
    """A CBD marker (Part 2): each component's bit depth byte (sign in bit
    7, precision - 1 below)."""
    return marker_segment(0xFF78, struct.pack(">H", len(depths))
                          + bytes(depths))


def with_segments(codestream: bytes, *segments: bytes, tile: int = -1,
                  rsiz: int = None) -> bytes:
    """A codestream with marker segments put in its main header before the
    first SOT, or with tile >= 0 into that tile-part's header (its Psot
    grown); rsiz sets SIZ's Rsiz."""
    extra = b"".join(segments)
    if rsiz is not None:
        codestream = codestream[:6] + struct.pack(">H", rsiz) + \
            codestream[8:]
    pos = codestream.index(b"\xff\x90")
    if tile < 0:
        return codestream[:pos] + extra + codestream[pos:]
    for _ in range(tile):
        pos += struct.unpack_from(">I", codestream, pos + 6)[0]
    psot = struct.unpack_from(">I", codestream, pos + 6)[0]
    return (codestream[:pos + 6] + struct.pack(">I", psot + len(extra))
            + codestream[pos + 10:pos + 12] + extra + codestream[pos + 12:])


def cod_mct(codestream: bytes, mct: int) -> bytes:
    """The codestream with its main COD's SGcod MCT byte set."""
    cod = codestream.index(b"\xff\x52")
    return codestream[:cod + 8] + bytes((mct,)) + codestream[cod + 9:]


def lab_of(rgb: np.ndarray) -> np.ndarray:
    """sRGB u8 [h, w, 3] -> Pillow's LAB bands (L, a + 128, b + 128)
    through Pillow's own LittleCMS transform (the bands as they are: an
    array of the image would pack a and b signed)."""
    lab = PILImage.fromarray(rgb).convert("LAB")
    return np.stack([np.asarray(band) for band in lab.split()], -1)


def tail_fixtures(rng) -> dict:
    """Small files of what Pillow opens and the port decodes since
    the tail of TIFF, PSD and JPEG 2000 was ported: JPEG 2000 Part 2
    markers (MCT records of each element type, MCC collections, MCO orders
    in the main and a tile-part header, OpenJPEG's own custom-transform
    stream with its COD's MCT set to 1, a CBD, ATK and ADS markers);
    old-style JPEG TIFFs in each form (a stream in the strips, a
    JPEGInterchangeFormat header, tables in tags), grey and YCbCr 1x1, 2x1
    and 2x2, several strips and restart intervals; ThunderScan TIFFs; JPEG
    YCbCr in separate planes; CIE L*a*b* TIFFs and LAB PSDs."""
    out = {}
    planes = [p.astype(np.int32) for p in np.moveaxis(
        smooth_image(rng, 6, 7, 25.0), 2, 0)]
    rgb = j2k_encode(planes)
    irr = j2k_encode(planes, irreversible=True)
    offsets = [(0, [10, 20, 30]), (1, [-5, 140, 300]),
               (2, [120.7, -3.2, 64.5]), (3, [100.25, 128.0, 150.9])]
    for element, values in offsets:
        kind = ("int16", "int32", "float32", "float64")[element]
        out[f"j2k_part2_mct_offsets_{kind}_6x7.j2k"] = ("j2k", with_segments(
            rgb, mct_segment(1, values, element), mcc_segment(0, 3, offset=1),
            mco_segment(0), rsiz=0x8100))
    eye = np.eye(3).ravel().tolist()
    out["j2k_part2_deco3x3_float_offsets_97_6x7.j2k"] = ("j2k", with_segments(
        irr, mct_segment(1, eye, 2, 1), mct_segment(2, [90, 128, 170], 1),
        mcc_segment(0, 3, deco=1, offset=2), mco_segment(0), rsiz=0x8100))
    out["j2k_part2_mcc_mco_no_offsets_6x7.j2k"] = ("j2k", with_segments(
        rgb, mct_segment(1, eye, 2, 1), mcc_segment(0, 3, deco=1),
        mco_segment(0)))
    out["j2k_part2_mco_in_tile_6x7.j2k"] = ("j2k", with_segments(
        rgb, mct_segment(3, [30, 60, 90]), mcc_segment(4, 3, offset=3),
        mco_segment(4), tile=0))
    matrix = [[0.5, 0.25, 0.25], [0.0, 1.0, -1.0], [1.0, 0.0, -1.0]]
    custom = j2k_encode(planes, mct_matrix=matrix, mct_shift=[4, 8, 12])
    out["j2k_part2_opj_mct3x3_cod_mct1_6x7.j2k"] = ("j2k", cod_mct(custom, 1))
    rgba = planes + [planes[0] // 2 + 60]
    custom4 = j2k_encode(rgba, mct_matrix=np.eye(4) * 0.5 + 0.125,
                         mct_shift=[1, 2, 3, 4])
    out["j2k_part2_opj_mct4x4_cod_mct0_6x7.j2k"] = ("j2k", cod_mct(custom4,
                                                                   0))
    out["j2k_part2_cbd_signed_6x7.j2k"] = ("j2k", with_segments(
        rgb, cbd_segment(0x87, 0x87, 0x87)))
    out["j2k_part2_cbd12_97_6x7.j2k"] = ("j2k", with_segments(
        irr, cbd_segment(11, 11, 11)))
    out["j2k_part2_atk_ads_6x7.j2k"] = ("j2k", with_segments(
        rgb, marker_segment(0xFF79, bytes((0, 2, 0, 1))),
        marker_segment(0xFF73, bytes((0, 1, 2, 3, 4, 5)))))
    out["jp2_part2_mct_offsets_6x7.jp2"] = ("jp2", jp2_file(with_segments(
        rgb, mct_segment(1, [64, 128, 192]), mcc_segment(0, 3, offset=1),
        mco_segment(0))))
    # old-style JPEG
    img = smooth_image(rng, 24, 32, 20.0)
    odd = smooth_image(rng, 13, 11, 20.0)
    for name, px, kw in (
            ("grey_stream_13x11", odd[..., :1], dict(photometric=1)),
            ("grey_jif_3strips_24x32", img[..., :1],
             dict(photometric=1, form="jif", rows_per_strip=8)),
            ("grey_tables_restart2_24x32", img[..., :1],
             dict(photometric=0, form="tables", restart=2)),
            ("ycbcr22_stream_13x11", odd, dict(photometric=6, subsampling=2)),
            ("ycbcr22_jif_2strips_24x32", img,
             dict(photometric=6, subsampling=2, form="jif",
                  rows_per_strip=16)),
            ("ycbcr11_tables_mm_13x11", odd,
             dict(photometric=6, subsampling=0, form="tables", order=">")),
            ("ycbcr21_tables_restart3_24x32", img,
             dict(photometric=6, subsampling=1, form="tables", restart=3)),
            ("rgb_as_ycbcr22_tables_2strips_24x32", img,
             dict(photometric=2, subsampling=2, form="tables",
                  rows_per_strip=16))):
        out[f"tiff_ojpeg_{name}.tif"] = ("tiff", ojpeg_tiff(px, **kw))
    # ThunderScan
    for name, w, h, rps, photo in (("odd_7x5", 7, 5, None, 1),
                                   ("strips_33x9", 33, 9, 4, 1),
                                   ("miniswhite_16x6", 16, 6, 3, 0)):
        px = (np.cumsum(rng.integers(-2, 3, (h, w)), 1) % 16).astype(
            np.uint8)
        step = rps or h
        strips = [b"".join(thunder_row(r, rng) for r in px[y:y + step])
                  for y in range(0, h, step)]
        out[f"tiff_thunderscan_{name}.tif"] = ("tiff", tiff_file(
            px[..., None], 4, photo, compression=32809, raw_strips=strips,
            rows_per_strip=rps))
    # JPEG YCbCr in separate planes
    strips = [_pillow(PILImage.fromarray(odd[y:y + 8, :, k]), "JPEG",
                      quality=90)
              for k in range(3) for y in range(0, 13, 8)]
    out["tiff_jpeg_ycbcr_planes_13x11.tif"] = ("tiff", tiff_file(
        np.zeros((13, 11, 3), np.uint8), 8, 6, compression=7, planar=2,
        rows_per_strip=8, raw_strips=strips, extra_tags=[(530, 3, (1, 1))]))
    # CIE L*a*b*
    lab = lab_of(odd)
    signed = lab ^ np.array([0, 128, 128], np.uint8)
    out["tiff_lab_ii_13x11.tif"] = ("tiff", tiff_file(signed, 8, 8))
    out["tiff_lab_mm_deflate_pred2_13x11.tif"] = ("tiff", tiff_file(
        signed, 8, 8, order=">", compression=8, predictor=2))
    out["tiff_lab_planar_lzw_13x11.tif"] = ("tiff", tiff_file(
        lab, 8, 8, planar=2, compression=5))
    for rle in (False, True):
        out[f"psd_lab_{'packbits' if rle else 'raw'}_13x11.psd"] = (
            "psd", psd_file(11, 13, 9, 8, list(np.moveaxis(lab, 2, 0)),
                            rle=rle, rng=rng))
    return out


TAIL_DIR = os.path.join(OUT, "pillow_tail")
TAIL_CHIP_DIR = os.path.join(OUT, "tail_chip")
LAB_CROP = 512
TAIL_LAB = f"tiff_lab_deflate_pred2_crop{LAB_CROP}.tif"
TAIL_MCT = "jp2_part2_mct_offsets_97_1024.jp2"
TAIL_OJPEG = "tiff_ojpeg_ycbcr22_jif_strips_q85_1024.tif"


def tail_chip_files(texels: np.ndarray) -> dict:
    """The chip path's files of BIG's texels: their top-left 512x512 crop
    as a Deflate CIE L*a*b* TIFF (predictor 2; the Lab of Pillow's own
    transform), the texels as a lossy JP2 whose codestream carries Part 2
    MCT, MCC and MCO markers (offsets 126, 128 and 130 in place of the
    level shift), and as an old-style JPEG TIFF (YCbCr 2x2 at quality 85,
    a JPEGInterchangeFormat header and 64-row strips)."""
    crop = texels[:LAB_CROP, :LAB_CROP]
    lab = lab_of(crop) ^ np.array([0, 128, 128], np.uint8)
    lab_tiff = tiff_file(lab, 8, 8, compression=8, predictor=2,
                         rows_per_strip=32)
    planes = list(np.moveaxis(texels, 2, 0).astype(np.int32))
    lossy = j2k_encode(planes, irreversible=True, mct=True,
                       layers=[40.0], codeblock=(32, 32))
    mct = jp2_file(with_segments(
        lossy, mct_segment(1, [126, 128, 130]), mcc_segment(0, 3, offset=1),
        mco_segment(0), rsiz=0x8100))
    ojpeg = ojpeg_tiff(texels, 6, form="jif", subsampling=2, quality=85,
                       rows_per_strip=64)
    return {TAIL_LAB: ("tiff", lab_tiff), TAIL_MCT: ("jp2", mct),
            TAIL_OJPEG: ("tiff", ojpeg)}


def write_tail() -> None:
    """Write tail_fixtures and tail_chip_files, each folder with its
    manifest."""
    files = _write(TAIL_DIR, tail_fixtures(np.random.default_rng(25)))
    _manifest(os.path.join(TAIL_DIR, "manifest.json"), files)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(TAIL_DIR, REPO)}")
    with PILImage.open(os.path.join(OUT, BIG)) as im:
        texels = np.asarray(im.convert("RGB"))
    chip = _write(TAIL_CHIP_DIR, tail_chip_files(texels))
    _manifest(os.path.join(TAIL_CHIP_DIR, "manifest.json"), chip)
    print(f"{len(chip)} chip-path files, {sum(x['bytes'] for x in chip)} "
          f"bytes, in {os.path.relpath(TAIL_CHIP_DIR, REPO)}")


def pnm_ext_file(magic: str, samples: np.ndarray, maxval: int,
                 sep: str = "\n") -> bytes:
    """A binary PNM of one of Pillow's other PpmImagePlugin modes (P0CMYK,
    PyP, PyRGBA, PyCMYK): samples [h, w] or [h, w, k] at maxval, 2 bytes a
    sample past 255."""
    h, w = samples.shape[:2]
    head = sep.join([magic, f"{w} {h}", str(maxval)]) + "\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head.encode() + np.asarray(samples).astype(dt).tobytes()


def pfm_file(v: np.ndarray, scale: float = -1.0, head: str = "") -> bytes:
    """A grey PFM ("Pf") of float32 v [h, w], rows bottom-up as PFM keeps
    them, little-endian at a negative scale."""
    h, w = v.shape
    head = head or f"Pf\n{w} {h}\n{scale!r}\n"
    dt = "<f4" if scale < 0 else ">f4"
    return head.encode() + np.asarray(v, np.float32)[::-1].astype(
        dt).tobytes()


def xbm_file(bits: np.ndarray, name: str = "t", hotspot=None,
             fmt: str = "0x{:02x}", per_line: int = 12,
             lead: bytes = b"", tail: bytes = b"};\n") -> bytes:
    """An XBM of bits [h, w] (1 white): each row's bytes least significant
    bit first, each written with fmt."""
    h, w = bits.shape
    rows = np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little")
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot:
        head += (f"#define {name}_x_hot {hotspot[0]}\n"
                 f"#define {name}_y_hot {hotspot[1]}\n")
    vals = [fmt.format(int(b)) for b in rows.reshape(-1)]
    body = ",\n".join(", ".join(vals[i:i + per_line])
                      for i in range(0, len(vals), per_line))
    return (lead + head.encode() + f"static char {name}_bits[] = {{\n"
            .encode() + body.encode() + b"\n" + tail)


def xpm_file(idx: np.ndarray, keys: list, specs: list, *,
             pixels_comment: bool = False, name: str = "t",
             extra_rows: list = ()) -> bytes:
    """An XPM of palette indices idx [h, w]: colour i's key keys[i] (bytes,
    all of one length) and spec specs[i] (bytes, as "c #rrggbb"), the
    pixel rows after them (and after a "/* pixels */" line if asked), then
    extra_rows as they are."""
    h, w = idx.shape
    bpp = len(keys[0])
    out = [b"/* XPM */", f"static char *{name}[] = {{".encode(),
           f'"{w} {h} {len(keys)} {bpp}",'.encode()]
    out += [b'"' + k + b" " + s + b'",' for k, s in zip(keys, specs)]
    if pixels_comment:
        out.append(b"/* pixels */")
    out += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in idx]
    out += list(extra_rows)
    return b"\n".join(out) + b"\n};\n"


def rgb_specs(colours: np.ndarray) -> list:
    return [b"c #%02x%02x%02x" % tuple(int(v) for v in c) for c in colours]


def xpm_keys(n: int, bpp: int) -> list:
    """n distinct keys of bpp printable characters (no quote or
    backslash)."""
    chars = [bytes((c,)) for c in range(35, 127) if c != 92]
    keys = []
    for i in range(n):
        k = b""
        for _ in range(bpp):
            k += chars[i % len(chars)]
            i //= len(chars)
        keys.append(k)
    return keys


def x11_pnm_fixtures(rng) -> dict:
    """Pillow's other PNM modes, XBM and XPM: Pillow-written files where
    Pillow writes them (XBM of mode 1, PPM of mode F), and hand-made ones
    of every quirk the port follows: Pf in either byte order with
    fractions, negatives, values past 255 and infinities; P0CMYK and PyCMYK
    at maxvals 255, 1000 and 65535; PyRGBA; PyP (black, as it has no
    palette); XBM with a hotspot, one-digit and upper-case hex bytes,
    leading whitespace and "x" alone in front; XPM of 1 and 2 characters a
    pixel, several keys a colour, a "/* pixels */" line, an unused "None"
    colour, quotes inside a pixel row, rows past the image, and 300
    colours (an RGB image)."""
    out = {}
    h, w = 6, 9
    f = rng.uniform(-40.0, 300.0, (h, w)).astype(np.float32)
    f.reshape(-1)[:6] = (np.inf, -np.inf, 254.999, 0.5, 255.0, -0.0)
    out["pfm_le_6x9.pfm"] = ("pnm_pf", pfm_file(f, -1.0))
    out["pfm_be_scale2_6x9.pfm"] = ("pnm_pf", pfm_file(f, 2.5))
    out["pfm_pillow_6x9.pfm"] = ("pnm_pf", _pillow(PILImage.fromarray(
        rng.uniform(-5.0, 260.0, (h, w)).astype(np.float32), "F"), "PPM"))
    cmyk = rng.integers(0, 256, (h, w, 4))
    out["pnm_p0cmyk_255.pnm"] = ("pnm_cmyk", pnm_ext_file("P0CMYK", cmyk,
                                                          255))
    out["pnm_p0cmyk_maxval1000.pnm"] = ("pnm_cmyk", pnm_ext_file(
        "P0CMYK", rng.integers(0, 1001, (h, w, 4)), 1000, " "))
    out["pnm_pycmyk_65535.pnm"] = ("pnm_cmyk", pnm_ext_file(
        "PyCMYK", rng.integers(0, 65536, (h, w, 4)), 65535))
    out["pnm_pyrgba_255.pnm"] = ("pnm_rgba", pnm_ext_file(
        "PyRGBA", rng.integers(0, 256, (h, w, 4)), 255))
    out["pnm_pyrgba_maxval15.pnm"] = ("pnm_rgba", pnm_ext_file(
        "PyRGBA", rng.integers(0, 16, (h, w, 4)), 15, "\t"))
    out["pnm_pyp_255.pnm"] = ("pnm_p", pnm_ext_file(
        "PyP", rng.integers(0, 256, (h, w)), 255))
    for hw in ((1, 1), (5, 10), (7, 17)):
        im = PILImage.fromarray(rng.integers(0, 2, hw).astype(bool))
        out[f"xbm_pillow_{hw[0]}x{hw[1]}.xbm"] = ("xbm", _pillow(im, "XBM"))
    out["xbm_pillow_hotspot.xbm"] = ("xbm", _pillow(PILImage.fromarray(
        rng.integers(0, 2, (4, 12)).astype(bool)), "XBM", hotspot=(3, 2)))
    bits = rng.integers(0, 2, (5, 13))
    out["xbm_one_digit_upper.xbm"] = ("xbm", xbm_file(
        bits, "icon", fmt="0x{:X}", per_line=3, lead=b"  \n"))
    out["xbm_no_zero_prefix.xbm"] = ("xbm", xbm_file(
        bits, "b", hotspot=(1, 1), fmt="x{:02x}", per_line=40,
        tail=b"};\n/* x */\n"))
    idx = rng.integers(0, 4, (h, w))
    colours = rng.integers(0, 256, (4, 3))
    out["xpm_1char.xpm"] = ("xpm", xpm_file(idx, [b"a", b"b", b".", b"#"],
                                            rgb_specs(colours)))
    specs = [b"s one m white c #%02x%02x%02x g #000000" % tuple(c)
             for c in colours.tolist()]
    out["xpm_2char_keys_pixels.xpm"] = ("xpm", xpm_file(
        idx, [b"aa", b"ab", b"ba", b"  "], specs, pixels_comment=True))
    keys = [b"a", b"b", b"c", b"d", b"n"]
    out["xpm_none_unused_extra_rows.xpm"] = ("xpm", xpm_file(
        idx, keys, rgb_specs(colours) + [b"c None"],
        extra_rows=[b'"abcd",', b"junk without quotes"]))
    # quotes inside the rows: the text between the first and the last
    # quote, '"' a key of its own
    out["xpm_inner_quotes.xpm"] = ("xpm", b'/* XPM */\nstatic char *q[] = '
                                   b'{\n"3 2 3 1",\n"a c #ff0000",\n"b c '
                                   b'#00ff00",\n"" c #0000ff",\n"a"b",\n'
                                   b'"b""",\n};\n')
    many = rng.integers(0, 256, (300, 3))
    big = rng.integers(0, 300, (5, 7))
    out["xpm_300_colours_rgb.xpm"] = ("xpm_rgb", xpm_file(
        big, xpm_keys(300, 2), rgb_specs(many)))
    return out


def fault_fixtures(rng) -> dict:
    """Damaged files on which the port once parted from JAX's loader and
    which Pillow decodes: a Huffman JPEG without its EOI whose data, with
    the bytes after them, stay within libjpeg's read-ahead; JPEG headers
    damaged as Pillow's marker walk and libjpeg take them (a comment
    of length 0, 16-bit quantisation entries under precision 2, the
    Huffman tables left out and libjpeg's standard ones used, an all-ones
    code in a table no scan uses); PNGs whose chunks Pillow's handlers
    pass (a palette image whose PLTE comes after its data, an APNG frame
    smaller than the image, text and profile chunks, interlace method 2);
    an old-style JPEG TIFF of one strip whose JPEGInterchangeFormatLength
    is 0, so that libtiff reads its header on to the end of the file."""
    out = {}
    px = smooth_image(rng, 40, 56, 30.0)
    jpeg = _pillow(PILImage.fromarray(px), "JPEG", quality=90)
    cut = jpeg[:-2]
    for k in range(64):
        data = cut + bytes((i * 37 + 11) % 250 + 1 for i in range(k))
        try:
            PILImage.open(io.BytesIO(data)).convert("RGB")
        except OSError:
            continue
        out[f"jpeg_no_eoi_tail{k}.jpg"] = ("jpeg_no_eoi", data)
        break
    rst = _pillow(PILImage.fromarray(px), "JPEG", quality=85,
                  restart_marker_blocks=3)[:-2]
    for k in range(64):
        data = rst + bytes(k)
        try:
            PILImage.open(io.BytesIO(data)).convert("RGB")
        except OSError:
            continue
        out[f"jpeg_no_eoi_restarts_tail{k}.jpg"] = ("jpeg_no_eoi", data)
        break
    sos = jpeg.index(b"\xff\xdb")
    out["jpeg_com_length0.jpg"] = ("jpeg_header", jpeg[:sos] + b"\xff\xfe"
                                   b"\x00\x00" + jpeg[sos:])
    dqt = jpeg.index(b"\xff\xdb")
    table = jpeg[dqt + 5:dqt + 69]
    wide = (b"\xff\xdb\x00\x83\x20" + np.frombuffer(table, np.uint8)
            .astype(">u2").tobytes())
    out["jpeg_dqt_precision2.jpg"] = ("jpeg_header", jpeg[:dqt] + wide
                                      + jpeg[dqt + 69:])
    segs, pos = [], 2
    while True:
        m, n = jpeg[pos + 1], struct.unpack_from(">H", jpeg, pos + 2)[0]
        segs.append((m, jpeg[pos:pos + 2 + n]))
        if m == 0xDA:
            break
        pos += 2 + n
    head = b"".join(seg for m, seg in segs if m != 0xC4)
    out["jpeg_std_huffman_tables.jpg"] = ("jpeg_header", b"\xff\xd8" + head
                                          + jpeg[pos + 2 + n:])
    # AC table 3: two codes of 1 bit, the second all ones
    bogus = (b"\xff\xc4" + struct.pack(">H", 21) + b"\x13" + bytes((2,))
             + bytes(15) + b"\x00\x01")
    out["jpeg_unused_bad_dht.jpg"] = ("jpeg_header", jpeg[:dqt] + bogus
                                      + jpeg[dqt:])
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    ind = rng.integers(0, 16, (9, 11)).astype(np.uint8)
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 3, 0, 0, 0))
    idat = _chunk(b"IDAT", zlib.compress(_filter_rows(ind, 1, (0, 1, 2))))
    sig = b"\x89PNG\r\n\x1a\n"
    out["png_plte_after_idat.png"] = ("png_chunks", sig + ihdr + idat
                                      + _chunk(b"PLTE", pal.tobytes())
                                      + _chunk(b"IEND", b""))
    rgb = smooth_image(rng, 12, 14, 20.0)
    frame = rgb[:7, :9]
    fctl = struct.pack(">IIIIIHHBB", 0, 9, 7, 3, 4, 1, 10, 0, 0)
    out["png_apng_frame_3_4.png"] = ("png_chunks", sig + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", 14, 12, 8, 2, 0, 0, 0))
        + _chunk(b"acTL", struct.pack(">II", 1, 0)) + _chunk(b"fcTL", fctl)
        + _chunk(b"IDAT", zlib.compress(_filter_rows(frame.reshape(7, 27),
                                                     3, (4,))))
        + _chunk(b"IEND", b""))
    text = (_chunk(b"zTXt", b"k\x00\x00" + zlib.compress(b"zipped"))
            + _chunk(b"iTXt", b"t\x00\x01\x00en\x00T\x00" + zlib.compress(
                "été".encode()))
            + _chunk(b"iCCP", b"icc\x00\x00" + zlib.compress(b"p" * 40)))
    grey = rng.integers(0, 256, (6, 8), dtype=np.uint8)
    out["png_text_profile_chunks.png"] = ("png_chunks", sig + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", 8, 6, 8, 0, 0, 0, 0)) + text
        + _chunk(b"IDAT", zlib.compress(_filter_rows(grey, 1, (0,))))
        + _chunk(b"IEND", b""))
    adam7 = png_file(grey[..., None], 8, 0, interlace=True)
    out["png_interlace_method2.png"] = ("png_chunks", adam7[:28] + b"\x02"
                                        + struct.pack(">I", zlib.crc32(
                                            adam7[12:28] + b"\x02"))
                                        + adam7[33:])
    oj = ojpeg_tiff(smooth_image(rng, 24, 16, 25.0)[..., :1], 1, form="jif")
    ifd = struct.unpack_from("<I", oj, 4)[0]
    for i in range(struct.unpack_from("<H", oj, ifd)[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", oj, e)[0] == 514:
            oj = oj[:e + 8] + struct.pack("<I", 0) + oj[e + 12:]
    out["tiff_ojpeg_jif_to_the_end.tif"] = ("ojpeg_tables", oj)
    return out


# ------------------------------------------- GBR, FLI, MSP, PCD, PIXAR, XV


def gbr_file(px: np.ndarray, version: int = 2, comment: bytes = b"brush\0",
             spacing: int = 25, header_size=None, tail: bytes = b"") -> bytes:
    """A GIMP brush of px [h, w] (grey, depth 1) or [h, w, 4] (RGBA,
    depth 4), with a comment; header_size overrides the header's size
    field (the comment's length follows from it)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else px.shape[2]
    fixed = 20 if version == 1 else 28
    size = fixed + len(comment) if header_size is None else header_size
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + comment + px.tobytes() + tail


def fli_header(w: int, h: int, *, flc: bool = True, frames: int = 1,
               flags: int = 3) -> bytes:
    """The 128-byte FLI (0xAF11) or FLC (0xAF12) header."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 0, 0xAF12 if flc else 0xAF11,
                     frames, w, h, 8, flags, 5)
    return bytes(head)


def fli_chunk(kind: int, body: bytes, size=None) -> bytes:
    """A sub-chunk: its size (6 + the body's, unless given) and type."""
    return struct.pack("<IH", 6 + len(body) if size is None else size,
                       kind) + body


def fli_frame(chunks: list, size=None, count=None, kind: int = 0xF1FA,
              pad: bool = False) -> bytes:
    """A frame chunk of the sub-chunks (a pad byte after them if asked)."""
    body = b"".join(chunks) + (b"\0" if pad else b"")
    return struct.pack("<IHH8x", 16 + len(body) if size is None else size,
                       kind, len(chunks) if count is None else count) + body


def fli_colors(packets: list, shift: int = 0) -> bytes:
    """A COLOR_256 (shift 0) or COLOR_64 (shift 2) body: each packet
    (entries skipped, [n, 3] colours; 256 colours are written as a count
    of 0)."""
    out = struct.pack("<H", len(packets))
    for skip, colours in packets:
        colours = np.asarray(colours, np.uint8)
        out += bytes((skip, len(colours) % 256)) + (
            colours >> np.uint8(shift)).tobytes()
    return out


def _runs(row: np.ndarray, most_run: int, most_literal: int) -> list:
    """Greedy packets of a row: ("run", n, v) for 3 or more equal bytes,
    else ("literal", bytes)."""
    out, x, w = [], 0, len(row)
    while x < w:
        n = 1
        while x + n < w and n < most_run and row[x + n] == row[x]:
            n += 1
        if n >= 3:
            out.append(("run", n, int(row[x])))
            x += n
            continue
        start = x
        while x < w and x - start < most_literal:
            if x + 2 < w and row[x] == row[x + 1] == row[x + 2]:
                break
            x += 1
        out.append(("literal", row[start:x].tobytes()))
    return out


def fli_brun(idx: np.ndarray) -> bytes:
    """A BRUN body of palette indices idx [h, w]: each line a packet count
    byte (not read) and runs (count, byte) or literals (256 - n, bytes)."""
    out = bytearray()
    for row in np.asarray(idx, np.uint8):
        packets = _runs(row, 127, 128)
        out.append(len(packets) % 256)
        for p in packets:
            if p[0] == "run":
                out += bytes((p[1], p[2]))
            else:
                out += bytes((256 - len(p[1]),)) + p[1]
    return bytes(out)


def fli_lc(prev: np.ndarray, new: np.ndarray) -> bytes:
    """An LC (byte delta) body turning prev [h, w] into new: the first
    changed line, the count of lines through the last changed one, each a
    packet count, then (skip, count, bytes) or (skip, 256 - n, byte)
    packets over its changed spans."""
    changed = np.nonzero((prev != new).any(axis=1))[0]
    if not len(changed):
        return struct.pack("<HH", 0, 0)
    y0, y1 = int(changed[0]), int(changed[-1]) + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        packets, x, w = [], 0, new.shape[1]
        diff = prev[y] != new[y]
        while x < w:
            start = x
            while x < w and not diff[x]:
                x += 1
            if x == w:
                break
            while x - start > 255:                 # a skip of 255 alone
                packets.append(bytes((255, 0)))
                start += 255
            end = x
            while end < w and diff[end]:
                end += 1
            for kind, *rest in _runs(new[y, x:end], 128, 127):
                if kind == "run":
                    packets.append(bytes((x - start, 256 - rest[0],
                                          rest[1])))
                    x += rest[0]
                else:
                    packets.append(bytes((x - start, len(rest[0])))
                                   + rest[0])
                    x += len(rest[0])
                start = x
        out.append(len(packets))
        out += b"".join(packets)
    return bytes(out)


def fli_ss2(prev: np.ndarray, new: np.ndarray) -> bytes:
    """An SS2 (word delta) body turning prev [h, w] into new: lines
    skipped by skip words, an odd width's last byte by a flag word, each
    changed line's word pairs as (skip, count, words) or (skip, 256 - n,
    word) packets."""
    h, w = new.shape
    even = w - w % 2
    lines, out, gap = 0, bytearray(), 0
    for y in range(h):
        if (prev[y] == new[y]).all():
            gap += 1
            continue
        if gap:
            out += struct.pack("<H", 65536 - gap)
            gap = 0
        if w % 2:
            out += struct.pack("<H", 0x8000 | int(new[y, -1]))
        words = new[y, :even].reshape(-1, 2)
        diff = (prev[y, :even] != new[y, :even]).reshape(-1, 2).any(axis=1)
        packets, i, x = [], 0, 0
        while i < len(words):
            while i < len(words) and not diff[i]:
                i += 1
            if i == len(words):
                break
            while 2 * i - x > 255:
                packets.append(bytes((254, 0)))
                x += 254
            j = i
            while j < len(words) and diff[j]:
                j += 1
            k = i
            while k < j:
                n = 1
                while k + n < j and n < 128 and (words[k + n] ==
                                                  words[k]).all():
                    n += 1
                if n >= 2:
                    packets.append(bytes((2 * k - x, 256 - n))
                                   + words[k].tobytes())
                else:
                    n = min(j - k, 127)
                    packets.append(bytes((2 * k - x, n))
                                   + words[k:k + n].tobytes())
                k += n
                x = 2 * k
            i = j
        out += struct.pack("<H", len(packets)) + b"".join(packets)
        lines += 1
    return struct.pack("<H", lines) + bytes(out)


def fli_file(frames_of_chunks: list, w: int, h: int, **kw) -> bytes:
    """An FLI / FLC of the frames, each a list of sub-chunks."""
    return fli_header(w, h, frames=len(frames_of_chunks), **kw) + b"".join(
        fli_frame(c) for c in frames_of_chunks)


def msp_file(bits: np.ndarray, kind: bytes = b"LinS", rows=None,
             checksum: bool = True) -> bytes:
    """A Windows Paint file of bits [h, w] (1 white): DanM raw rows, or
    LinS with a row map; rows overrides the encoded rows (bytes each, b""
    for a row of length 0)."""
    h, w = bits.shape
    head = bytearray(32)
    head[:4] = kind
    struct.pack_into("<HH", head, 4, w, h)
    if checksum:
        words = np.frombuffer(bytes(head), "<u2")
        struct.pack_into("<H", head, 30, int(np.bitwise_xor.reduce(words)))
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1)
    if kind == b"DanM":
        return bytes(head) + packed.tobytes()
    if rows is None:
        rows = [msp_row(r) for r in packed]
    return (bytes(head) + struct.pack(f"<{len(rows)}H", *map(len, rows))
            + b"".join(rows))


def msp_row(row: np.ndarray) -> bytes:
    """A LinS row: runs (0, count, byte), literals (n, bytes)."""
    out = bytearray()
    for p in _runs(np.asarray(row, np.uint8), 255, 255):
        if p[0] == "run":
            out += bytes((0, p[1], p[2]))
        else:
            out += bytes((len(p[1]),)) + p[1]
    return bytes(out)


def pcd_file(y: np.ndarray, c1: np.ndarray, c2: np.ndarray,
             orientation: int = 0) -> bytes:
    """A Kodak PhotoCD file of its base image: y [512, 768] and c1, c2
    [256, 384] PhotoYCC samples, "PCD_" at 2048 and the orientation byte
    at 3586, in chunks of two luma rows and a half row of each chroma."""
    head = bytearray(b"\xff" * 2048) + b"PCD_" + bytes(1535)
    head[3586] = orientation
    chunks = np.concatenate([np.asarray(y, np.uint8).reshape(256, 1536),
                             np.asarray(c1, np.uint8),
                             np.asarray(c2, np.uint8)], axis=1)
    return bytes(head).ljust(96 * 2048, b"\0") + chunks.tobytes()


def pixar_file(rgb: np.ndarray, channels: int = 14, depth: int = 2,
               tail: bytes = b"") -> bytes:
    """A PIXAR raster of rgb [h, w, 3] after its 1024-byte header."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, channels, depth)
    return bytes(head) + np.asarray(rgb, np.uint8).tobytes() + tail


def xv_file(idx: np.ndarray, comments=(b"#XVVERSION:Version 2.28",
                                       b"#END_OF_COMMENTS"),
            size_line: bytes = b"", rest: bytes = b"") -> bytes:
    """An XV thumbnail of RGB332 indices idx [h, w]: "P7 332" and the rest
    of its line, comment lines, the size line, the bytes."""
    h, w = idx.shape
    lines = [b"P7 332" + rest] + list(comments) + [
        size_line or b"%d %d 255" % (w, h)]
    return b"\n".join(lines) + b"\n" + np.asarray(idx, np.uint8).tobytes()


def rgb332(rgb: np.ndarray) -> np.ndarray:
    """The 3-3-2 indices of rgb [..., 3] (red's top three bits first)."""
    rgb = np.asarray(rgb, np.uint8)
    return (rgb[..., 0] >> 5 << 5 | rgb[..., 1] >> 5 << 2
            | rgb[..., 2] >> 6).astype(np.uint8)


def legacy_fixtures(rng, texels: np.ndarray) -> dict:
    """GIMP brushes, FLI / FLC, Windows Paint, Kodak PhotoCD, PIXAR and XV
    thumbnails, written by hand (Pillow writes only MSP's DanM): GBR
    versions 1 and 2, grey and RGBA, with comments; FLI and FLC of every
    chunk FliDecode takes (BRUN, COPY, LC, SS2 with skipped lines and an
    odd width's last byte, BLACK, a postage stamp) under COLOR_256 and
    COLOR_64 palettes of several packets, a palette after the image
    chunks, no palette, a frame whose pad byte is missing, and the files
    Pillow refuses (a prefix chunk, a palette past entry 255, an unknown
    chunk); MSP DanM and LinS (rows of length 0, a row that decodes long, a
    literal past a row's end); PCD of the texels (the 1024x1024 JPEG's)
    in orientations 0, 1 and 3; PIXAR RGB, and of another channel and
    depth code, which Pillow cannot open; XV thumbnails with comments and
    an extra field. {name: (kind, bytes)}."""
    out = {}
    out["gbr_v1_grey_7x5.gbr"] = ("gbr", gbr_file(
        rng.integers(0, 256, (5, 7)), 1, b"old brush\0"))
    out["gbr_v2_grey_9x4.gbr"] = ("gbr", gbr_file(
        rng.integers(0, 256, (4, 9)), 2, b"pencil\0", spacing=10))
    out["gbr_v2_rgba_6x8.gbr"] = ("gbr", gbr_file(
        rng.integers(0, 256, (8, 6, 4)), 2, b"colour brush\0"))
    out["gbr_v1_rgba_no_comment_tail.gbr"] = ("gbr", gbr_file(
        rng.integers(0, 256, (3, 3, 4)), 1, b"", tail=b"after the data"))
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    w, h = 13, 7
    a = rng.integers(0, 8, (h, w)).astype(np.uint8) * 3
    a[2, :] = 200                                      # a long run
    out["fli_color64_brun_13x7.fli"] = ("fli", fli_file(
        [[fli_chunk(11, fli_colors([(0, pal[:64] & 0xFC)], 2)),
          fli_chunk(15, fli_brun(a))]], w, h, flc=False, flags=0))
    out["flc_color256_brun_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(4, fli_colors([(0, pal)])), fli_chunk(15, fli_brun(a))]],
        w, h))
    b = a.copy()
    b[1:5, 3:9] = rng.integers(0, 256, (4, 6))
    b[6, :] = 17
    out["flc_copy_then_lc_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(4, fli_colors([(5, pal[:40]), (10, pal[100:200])])),
          fli_chunk(16, a.tobytes()), fli_chunk(12, fli_lc(a, b))]], w, h))
    c = a.copy()
    c[0, :12] = rng.integers(0, 256, 12)
    c[3, 4:10] = 9
    c[3, -1] = 250
    c[6, 2:4] = 77
    out["flc_brun_then_ss2_odd_width_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(4, fli_colors([(0, pal)])), fli_chunk(15, fli_brun(a)),
          fli_chunk(12, fli_lc(a, b)), fli_chunk(7, fli_ss2(b, c))]], w, h))
    out["flc_black_stamp_lc_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(16, a.tobytes()), fli_chunk(13, b""),
          fli_chunk(18, bytes(20)), fli_chunk(12, fli_lc(np.zeros_like(b),
                                                        b))]], w, h))
    out["flc_palette_after_image_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(15, fli_brun(a)),
          fli_chunk(11, fli_colors([(3, pal[:20] & 0xFC)], 2))]], w, h))
    wide = rng.integers(0, 4, (3, 300)).astype(np.uint8)
    wide[1] = np.arange(300) % 256
    out["flc_grey_brun_ss2_300x3.flc"] = ("fli", fli_file(
        [[fli_chunk(15, fli_brun(wide)),
          fli_chunk(7, fli_ss2(wide, wide[::-1].copy()))]], 300, 3))
    odd = fli_header(w, h) + fli_frame([fli_chunk(16, a.tobytes()[:-1] +
                                                  b"\x05")])
    out["flc_copy_odd_frame_no_pad_13x7.flc"] = ("fli", odd)
    out["flc_two_frames_13x7.flc"] = ("fli", fli_file(
        [[fli_chunk(4, fli_colors([(0, pal)])), fli_chunk(16, a.tobytes())],
         [fli_chunk(12, fli_lc(a, b))]], w, h))
    prefix = (fli_header(w, h) + struct.pack("<IH", 16, 0xF100) + bytes(10)
              + fli_frame([fli_chunk(4, fli_colors([(0, pal)])),
                           fli_chunk(16, a.tobytes())]))
    out["flc_prefix_chunk_13x7.flc"] = ("fli_refused", prefix)
    out["flc_palette_past_255_13x7.flc"] = ("fli_refused", fli_file(
        [[fli_chunk(4, fli_colors([(250, pal[:10])])),
          fli_chunk(16, a.tobytes())]], w, h))
    out["flc_unknown_chunk_13x7.flc"] = ("fli_refused", fli_file(
        [[fli_chunk(16, a.tobytes()), fli_chunk(99, bytes(4))]], w, h))
    bits = rng.integers(0, 2, (5, 13))
    out["msp_danm_13x5.msp"] = ("msp", msp_file(bits, b"DanM"))
    out["msp_pillow_danm_10x3.msp"] = ("msp", _pillow(PILImage.fromarray(
        rng.integers(0, 2, (3, 10)).astype(bool)), "MSP"))
    bits = rng.integers(0, 2, (6, 20))
    bits[2] = 1
    bits[3, :16] = 0
    out["msp_lins_20x6.msp"] = ("msp", msp_file(bits))
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    rows = [msp_row(r) for r in packed]
    rows[1] = b""                                   # a white row
    rows[4] = msp_row(packed[4]) + bytes((0, 3, 0x0F))   # decodes long
    out["msp_lins_white_and_long_rows_20x6.msp"] = ("msp", msp_file(
        bits, rows=rows))
    rows = [msp_row(r) for r in packed]
    rows[2] = bytes((9,)) + packed[2, :2].tobytes()     # literal past end
    rows[4] = msp_row(packed[4]) + bytes((0, 1, 0xAA))  # and one byte more
    out["msp_lins_literal_past_row_20x6.msp"] = ("msp", msp_file(
        bits, rows=rows))
    y = texels[:512, :768, 1]
    c1 = texels[:512:2, :768:2, 2]
    c2 = texels[1:512:2, 1:768:2, 0]
    for o in (0, 1, 3):
        out[f"pcd_texels_o{o}.pcd"] = ("pcd", pcd_file(y, c1, c2, o))
    rgb = rng.integers(0, 256, (5, 7, 3))
    out["pixar_rgb_7x5.pxr"] = ("pixar", pixar_file(rgb))
    out["pixar_rgb_tail_3x9.pxr"] = ("pixar", pixar_file(
        rng.integers(0, 256, (9, 3, 3)), tail=bytes(7)))
    out["pixar_channels_14_depth_1_7x5.pxr"] = ("pixar_refused", pixar_file(
        rgb, 14, 1))
    idx = rgb332(rng.integers(0, 256, (6, 9, 3)))
    out["xv_comments_9x6.xv"] = ("xv", xv_file(idx))
    out["xv_fields_8x3.xv"] = ("xv", xv_file(
        idx[:3, :8], (b"#IMGINFO:8x3 RGB", b"# more"), b"  8\t3 255 x",
        b" is a thumbnail"))
    return out


# ------------------------------------------------ science and legacy tools


def fits_card(key: bytes, value=None, comment: bytes = b"") -> bytes:
    """An 80-byte FITS header card: the keyword, "= " and the value
    right-aligned to column 30 where one is given, " / " and a comment."""
    card = key.ljust(8)
    if value is not None:
        card += b"= " + value.rjust(20)
    if comment:
        card += b" / " + comment
    return card.ljust(80)[:80]


def fits_hdu(cards: list) -> bytes:
    """A header unit: the cards, then END, padded with spaces to 2880
    bytes."""
    s = b"".join(cards) + fits_card(b"END")
    return s + b" " * (-len(s) % 2880)


FITS_TYPES = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_file(px: np.ndarray, bitpix: int = 8, cards=(), pad: bool = True,
              naxis=None) -> bytes:
    """A FITS primary image of px [h, w] as FITS orders it: rows from the
    bottom (the file's first row is the image's last), big-endian samples
    of BITPIX (8 unsigned, 16 and 32 signed, -32 and -64 IEEE), the data
    padded to 2880 bytes; cards go after NAXIS2 (naxis overrides the
    NAXIS cards)."""
    px = np.asarray(px)
    h, w = px.shape
    axes = naxis if naxis is not None else [
        fits_card(b"NAXIS", b"2"), fits_card(b"NAXIS1", b"%d" % w),
        fits_card(b"NAXIS2", b"%d" % h)]
    data = px[::-1].astype(FITS_TYPES[bitpix]).tobytes()
    return fits_hdu([fits_card(b"SIMPLE", b"T", b"a primary image"),
                     fits_card(b"BITPIX", b"%d" % bitpix), *axes,
                     *cards]) + data + (b"\0" * (-len(data) % 2880)
                                        if pad else b"")


def fits_gzip_file(samples: bytes, w: int, h: int, zbitpix: int = 8,
                   table: tuple = (8, 3), primary_cards=(),
                   member: bool = True) -> bytes:
    """A FITS of NAXIS 0 whose BINTABLE extension has ZIMAGE T and
    ZCMPTYPE 'GZIP_1  ' as Pillow's FitsGzipDecoder reads it: the table's
    NAXIS1 x NAXIS2 bytes (table, BITPIX 8), then one gzip stream of
    samples (4 bytes a pixel, of which Pillow keeps the last ZBITPIX / 8,
    rows from the bottom)."""
    head = fits_hdu([fits_card(b"SIMPLE", b"T"), fits_card(b"BITPIX", b"8"),
                     fits_card(b"NAXIS", b"0"), *primary_cards])
    ext = fits_hdu([
        fits_card(b"XTENSION", b"'BINTABLE'"), fits_card(b"BITPIX", b"8"),
        fits_card(b"NAXIS", b"2"), fits_card(b"NAXIS1", b"%d" % table[0]),
        fits_card(b"NAXIS2", b"%d" % table[1]), fits_card(b"ZIMAGE", b"T"),
        fits_card(b"ZBITPIX", b"%d" % zbitpix), fits_card(b"ZNAXIS", b"2"),
        fits_card(b"ZNAXIS1", b"%d" % w), fits_card(b"ZNAXIS2", b"%d" % h),
        fits_card(b"ZCMPTYPE", b"'GZIP_1  '")])
    body = gzip.compress(samples, mtime=0) if member else samples
    return head + ext + bytes(range(table[0] * table[1])) + body


def mcidas_file(px: np.ndarray, nbytes: int = 1, prefix: int = 0,
                offset: int = 256, words=None, tail: bytes = b"") -> bytes:
    """An McIdas area of px [h, w] or [h, w, bands] (each line holding
    its elements' bands one after another): the 256-byte directory of 64
    big-endian words (w[k] is word k, 1-based, as Pillow numbers them:
    w[2] = 4, w[9] lines, w[10] elements, w[11] bytes an element, w[14]
    bands, w[15] a line's prefix bytes, w[34] the first line's offset;
    words {k: value} sets any), zeros up to w[34], then each line's prefix
    and its samples, big-endian."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    d = [0] * 65
    d[2], d[9], d[10], d[11], d[15], d[34] = 4, h, w, nbytes, prefix, offset
    d[14] = px.shape[2] if px.ndim == 3 else 1
    for k, v in (words or {}).items():
        d[k] = v
    dt = {1: "u1", 2: ">u2", 4: ">u4"}[nbytes]
    lines = px.reshape(h, -1).astype(dt).view(np.uint8).reshape(h, -1)
    lines = np.concatenate([np.full((h, prefix), 0xA5, np.uint8), lines], 1)
    return (struct.pack("!64i", *d[1:]) + bytes(max(0, offset - 256))
            + lines.tobytes() + tail)


def spider_header(w: int, h: int, *, big: bool = True, iform: float = 1,
                  istack: float = 0, imgnumber: float = 0, maxim: float = 0,
                  lenbyt=None, labrec=None, values=None) -> bytes:
    """A SPIDER header (floats, 1-based as SPIDER numbers them: 1 nslice,
    2 nrow, 5 iform, 12 nsam, 13 labrec, 22 labbyt, 23 lenbyt, 24 istack,
    26 maxim, 27 imgnumber; values {k: v} sets others) padded to labbyt
    bytes, big- or little-endian."""
    lenbyt = w * 4 if lenbyt is None else lenbyt
    labrec = -(-1024 // lenbyt) if labrec is None else labrec
    labbyt = labrec * lenbyt
    hdr = [0.0] * max(28, labbyt // 4 + 1)
    hdr[1], hdr[2], hdr[3], hdr[5], hdr[12] = 1.0, h, h, iform, w
    hdr[13], hdr[22], hdr[23] = labrec, labbyt, lenbyt
    hdr[24], hdr[26], hdr[27] = istack, maxim, imgnumber
    for k, v in (values or {}).items():
        hdr[k] = v
    out = struct.pack((">" if big else "<") + f"{len(hdr) - 1}f", *hdr[1:])
    return out[:max(labbyt, 108)].ljust(max(labbyt, 108), b"\0")


def spider_file(px: np.ndarray, big: bool = True, **kw) -> bytes:
    """A SPIDER image of px [h, w] (float32 samples, rows from the top),
    its header from spider_header."""
    px = np.asarray(px, np.float32)
    h, w = px.shape
    return spider_header(w, h, big=big, **kw) + px.astype(
        ">f4" if big else "<f4").tobytes()


def im_file(image_type: bytes, w: int, h: int, body: bytes, lut=None,
            lines=(), eol: bytes = b"\r\n", pad: bool = True,
            size=None) -> bytes:
    """An IFUNC IM file: its header lines ("Image type", "Image size
    (x*y)" unless size gives that line's value, then lines, then "Lut"
    where lut [768] bytes is given: 256 reds, 256 greens, 256 blues),
    padded with NULs to 511 bytes as Pillow's writer pads it, 0x1A, the
    palette, the body."""
    head = [b"Image type: " + image_type,
            b"Image size (x*y): " + (b"%d*%d" % (w, h) if size is None
                                     else size), *lines]
    if lut is not None:
        head.append(b"Lut: 1")
    s = b"".join(x + eol for x in head)
    s += b"\0" * max(0, 511 - len(s)) if pad else b""
    return s + b"\x1a" + (bytes(lut) if lut is not None else b"") + body


# the bits a pixel of each of Pillow's IM raw layouts (ImImagePlugin.OPEN;
# F;N for the others), for the bodies' lengths
IM_BITS = {"1": 1, "L": 8, "P": 8, "P;2": 2, "P;4": 4, "RGB;L": 24,
           "RLB": 24, "RGB": 24, "I;32": 32, "F;32": 32, "RGB;T": 24,
           "RYB;T": 24, "LA;L": 16, "PA;L": 16, "RGBA;L": 32, "RGBX;L": 32,
           "CMYK;L": 32, "YCbCr;L": 24, "F;8": 8, "F;8S": 8, "F;16": 16,
           "F;16S": 16, "F;32F": 32, "I;16": 16, "I;16L": 16, "I;16B": 16,
           "I;32S": 32}


def im_body_size(rawmode: str, w: int, h: int) -> int:
    """The bytes of a w x h image in an IM raw layout: rows of whole bytes
    (three planes of the image for RGB;T and RYB;T)."""
    bits = IM_BITS.get(rawmode) or int(rawmode[2:])
    return -(-w * bits // 8) * h * (3 if rawmode.endswith(";T") else 1)


def imt_file(w: int, h: int, body: bytes, lines=None) -> bytes:
    """An IM Tools file: "width", "height" and "pixel n8" lines (or the
    lines given), a form feed, the body."""
    if lines is None:
        lines = [b"width %d" % w, b"height %d" % h, b"pixel n8"]
    return b"".join(x + b"\n" for x in lines) + b"\x0c" + body


def iptc_field(record: int, tag: int, data: bytes, long: bool = False
               ) -> bytes:
    """An IPTC/NAA field: 0x1C, its record and tag, its size in 2 bytes
    (or 0x84 and 4 bytes, long), the data."""
    size = (bytes((0x84,)) + struct.pack(">I", len(data)) if long
            else struct.pack(">H", len(data)))
    return bytes((0x1C, record, tag)) + size + data


def iptc_file(payload: bytes, w: int, h: int, layers: int = 1,
              component: int = 0, compression: int = 1, band=None,
              chunk: int = 8000, fields=(), tail: bytes = b"") -> bytes:
    """An IPTC/NAA stream: fields (3,60) layers and component, (3,20)
    and (3,30) the width and height, (3,120) the compression (1 raw, 5
    JPEG), (3,65) the band (1-based) where given, the extra fields, then
    the payload in (8,10) fields of chunk bytes (4-byte sizes past 32767),
    then tail."""
    head = [iptc_field(3, 60, bytes((layers, component))),
            iptc_field(3, 20, struct.pack(">I", w)),
            iptc_field(3, 30, struct.pack(">I", h)),
            iptc_field(3, 120, bytes((compression,)))]
    if band is not None:
        head.append(iptc_field(3, 65, bytes((band + 1,))))
    body = [iptc_field(8, 10, payload[i:i + chunk], long=chunk > 32767)
            for i in range(0, len(payload), chunk)]
    return b"".join(head) + b"".join(fields) + b"".join(body) + tail



def _grey_jpeg(px: np.ndarray, quality: int = 90) -> bytes:
    return _pillow(PILImage.fromarray(np.asarray(px, np.uint8)), "JPEG",
                   quality=quality)


SCIENCE_CROP = 256
SCIENCE_CHIP = f"iptc_jpeg_band2_crop{SCIENCE_CROP}.iim"


def science_fixtures(rng, texels: np.ndarray) -> dict:
    """FITS, McIdas, SPIDER, IM, IM Tools and IPTC/NAA files, written by
    hand but for Pillow's own IM and SPIDER saves: FITS at each BITPIX,
    NAXIS 1, an image extension after an empty primary unit and GZIP_1
    tables; McIdas of 1, 2 and 4 bytes, line prefixes, bands and strides
    shorter than a line; SPIDER of both byte orders and a stack; IM of
    every raw layout of Pillow's OPEN table, bit depths, a palette (Lut)
    of colour or of grey, odd headers; IM Tools with comments; IPTC raw and
    JPEG, L and with a band of RGB and CMYK, long and chunked fields;
    and the files Pillow refuses (listed by their error's name). Then
    SCIENCE_CHIP, the texels' (the 1024x1024 JPEG's) top-left crop's
    green as a grey JPEG in band 2 of an RGB IPTC stream, for chip_smoke.py
    phase 18c. {name: (kind, bytes)}."""
    out = {}

    def body(rawmode, w, h):
        return rng.integers(0, 256, im_body_size(rawmode, w, h)).astype(
            np.uint8).tobytes()

    px = rng.integers(0, 256, (5, 7))
    out["fits_bitpix8_7x5.fits"] = ("fits", fits_file(px, 8))
    v = rng.integers(-300, 3000, (4, 6))
    v[0, 0] = 300                                       # reads as 11265
    out["fits_bitpix16_6x4.fits"] = ("fits", fits_file(v, 16))
    out["fits_bitpix32_5x3.fits"] = ("fits", fits_file(
        rng.integers(-2 ** 31, 2 ** 31, (3, 5)), 32))
    f = rng.uniform(-5, 300, (4, 5)).astype(np.float32)
    f[0, 0] = 1.0                                       # reads as 4.6e-41
    out["fits_bitpix-32_5x4.fits"] = ("fits", fits_file(f, -32))
    # read as float32 pairs: whole numbers leave no NaN among them
    out["fits_bitpix-64_4x3.fits"] = ("fits", fits_file(
        rng.integers(-300, 300, (3, 4)).astype(np.float64) / 4, -64))
    out["fits_naxis1_9.fits"] = ("fits", fits_file(
        rng.integers(0, 256, (9, 1)), 8, naxis=[
            fits_card(b"NAXIS", b"1"), fits_card(b"NAXIS1", b"9")]))
    ext = fits_hdu([fits_card(b"SIMPLE", b"T"), fits_card(b"BITPIX", b"8"),
                    fits_card(b"NAXIS", b"0"), fits_card(b"EXTEND", b"T")])
    img = rng.integers(0, 256, (3, 6)).astype(np.uint8)
    out["fits_image_extension_6x3.fits"] = ("fits", ext + fits_hdu([
        fits_card(b"XTENSION", b"'IMAGE   '", b"an image extension"),
        fits_card(b"BITPIX", b"8"), fits_card(b"NAXIS", b"2"),
        fits_card(b"NAXIS1", b"6"), fits_card(b"NAXIS2", b"3")])
        + img.tobytes() + bytes(2880 - 18))
    out["fits_bscale_comments_6x2.fits"] = ("fits", fits_file(
        rng.integers(0, 256, (2, 6)), 8, cards=[
            fits_card(b"BSCALE", b"2.0", b"ignored by Pillow"),
            fits_card(b"BZERO", b"100"), fits_card(b"COMMENT")]))
    for zbits, (w, h) in ((8, (6, 5)), (16, (5, 4)), (32, (4, 3))):
        out[f"fits_gzip1_{zbits}bit_{w}x{h}.fits"] = ("fits", fits_gzip_file(
            rng.integers(0, 256, 4 * w * h).astype(np.uint8).tobytes(), w, h,
            zbits))
    out["fits_no_image_data.fits"] = ("fits_refused", ext + b"x" * 80)
    # Pillow keeps the last -32 // 8 = -4 bytes of each 4: none
    out["fits_gzip1_float.fits"] = ("fits_refused", fits_gzip_file(
        bytes(4 * 6), 3, 2, -32, table=(8, 8)))
    # the table and stream end within 80 bytes of the header: the data
    # offset is 80 bytes back from the file's end
    out["fits_gzip1_short_unit_offset_back.fits"] = ("fits_refused",
                                                     fits_gzip_file(
        bytes(4 * 6), 3, 2, 8))
    # the data's first read is 60 bytes short of a card: Pillow's offset
    # (80 bytes back from where it ended) is 20 bytes into the header
    out["fits_data_read_short_offset_back_8x8.fits"] = ("fits", fits_file(
        rng.integers(0, 256, (8, 8)), 8)[:2880 + 60])
    out["fits_data_cut_short_16x16.fits"] = ("fits_refused", fits_file(
        rng.integers(0, 256, (16, 16)), 8)[:2880 + 100])
    out["fits_naxis_not_an_int.fits"] = ("fits_refused", fits_file(
        px, 8, naxis=[fits_card(b"NAXIS", b"2.0")]))

    out["mcidas_8bit_7x5.mcidas"] = ("mcidas", mcidas_file(
        rng.integers(0, 256, (5, 7)), 1))
    out["mcidas_16bit_prefix_bands_6x4.mcidas"] = ("mcidas", mcidas_file(
        rng.integers(0, 600, (4, 6, 2)), 2, prefix=3, offset=300))
    out["mcidas_32bit_5x3.mcidas"] = ("mcidas", mcidas_file(
        rng.integers(0, 2 ** 32, (3, 5)), 4))
    out["mcidas_8bit_no_bands_overlapping_lines_6x4.mcidas"] = (
        "mcidas", mcidas_file(rng.integers(0, 256, (4, 6)), 1, prefix=2,
                              words={14: 0}, tail=bytes(30)))
    out["mcidas_16bit_stride_0_5x3.mcidas"] = ("mcidas", mcidas_file(
        rng.integers(0, 600, (3, 5)), 2, words={14: 0}, tail=bytes(40)))
    out["mcidas_8bit_cut_short_6x4.mcidas"] = ("mcidas_refused", mcidas_file(
        rng.integers(0, 256, (4, 6)), 1)[:-3])
    out["mcidas_32bit_stride_short.mcidas"] = ("mcidas_refused", mcidas_file(
        rng.integers(0, 256, (3, 4)), 4, words={14: 0, 15: 1}))

    sp = rng.uniform(-20, 300, (5, 7)).astype(np.float32)
    out["spider_pillow_7x5.spi"] = ("spider", _pillow(
        PILImage.fromarray(sp, "F"), "SPIDER"))
    out["spider_big_endian_6x4.spi"] = ("spider", spider_file(
        rng.uniform(0, 255, (4, 6))))
    out["spider_little_endian_5x9.spi"] = ("spider", spider_file(
        rng.uniform(0, 400, (9, 5)), big=False))
    stack = spider_header(5, 3, istack=2, maxim=2) + spider_file(
        rng.uniform(0, 255, (3, 5)))
    out["spider_stack_first_image_5x3.spi"] = ("spider", stack)
    out["spider_image_in_stack.spi"] = ("spider_refused", spider_file(
        rng.uniform(0, 255, (3, 5)), imgnumber=1))
    out["spider_cut_short_6x4.spi"] = ("spider_refused", spider_file(
        rng.uniform(0, 255, (4, 6)))[:-5])

    w, h = 5, 3
    names = {"1": b"0 1", "L": b"Greyscale", "P;2": b"B2", "P;4": b"B4",
             "RGB;L": b"RGB", "RGB": b"X 24", "I;32": b"L 32 S",
             "F;32": b"L 32 F", "RGB;T": b"RGB3", "RYB;T": b"RYB3",
             "LA;L": b"LA", "RGBA;L": b"RGBA", "RGBX;L": b"RGBX",
             "CMYK;L": b"CMYK", "YCbCr;L": b"YCC", "F;8": b"L 8",
             "F;8S": b"L*8S", "F;16": b"L*16", "F;16S": b"L 16S",
             "F;32F": b"L 32F", "I;16": b"L 16", "I;16L": b"L 16L",
             "I;16B": b"L*16B", "I;32S": b"L 32S", "F;3": b"L*3",
             "F;12": b"L*12", "F;24": b"L*24", "F;31": b"L*31"}
    for raw, kind in names.items():
        tag = raw.replace(";", "_")
        out[f"im_{tag}_{w}x{h}.im"] = ("im", im_file(
            kind + b" image", w, h, body(raw, w, h)))
    colour = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    grey = np.tile(np.arange(256, dtype=np.uint8)[::-1], 3).tobytes()
    out["im_L_colour_lut_6x4.im"] = ("im", im_file(
        b"Greyscale image", 6, 4, body("L", 6, 4), lut=colour))
    out["im_LA_colour_lut_6x4.im"] = ("im", im_file(
        b"LA image", 6, 4, body("LA;L", 6, 4), lut=colour))
    out["im_B2_colour_lut_reads_8bit_6x4.im"] = ("im", im_file(
        b"B2 image", 6, 4, body("P", 6, 4), lut=colour))
    out["im_L_grey_lut_ignored_6x4.im"] = ("im", im_file(
        b"Greyscale image", 6, 4, body("L", 6, 4), lut=grey))
    out["im_header_lf_comments_unpadded_4x3.im"] = ("im", im_file(
        b"RGB image", 4, 3, body("RGB;L", 4, 3), eol=b"\n", pad=False,
        lines=(b"Name: t.im", b"Comment: one", b"Comment: two",
               b"Scale (x,y): 1.5,2", b"Custom key: value"), size=b"4,3"))
    for mode in ("L", "RGB", "P", "CMYK", "YCbCr", "LA", "I", "F", "I;16B",
                 "1"):
        pim = PILImage.fromarray(rng.integers(0, 256, (4, 6, 3)).astype(
            np.uint8)).convert(mode)
        out[f"im_pillow_{mode.replace(';', '_')}_6x4.im"] = ("im", _pillow(
            pim, "IM"))
    out["im_RLB_no_unpacker.im"] = ("im_refused", im_file(
        b"RLB image", w, h, body("RLB", w, h)))
    out["im_PA_into_LA.im"] = ("im_refused", im_file(
        b"PA image", w, h, body("PA;L", w, h)))
    out["im_size_not_a_number.im"] = ("im_refused", im_file(
        b"Greyscale image", w, h, body("L", w, h), size=b"five*3"))
    out["im_cut_short_5x3.im"] = ("im_refused", im_file(
        b"RGB image", w, h, body("RGB;L", w, h)[:-1]))
    out["im_F_12_cut_short.im"] = ("im_refused", im_file(
        b"L*12 image", w, h, body("F;12", w, h)[:-2]))

    g = rng.integers(0, 256, (5, 8)).astype(np.uint8)
    out["imt_8x5.imt"] = ("imt", imt_file(8, 5, g.tobytes()))
    out["imt_comments_7x3.imt"] = ("imt", imt_file(7, 3, g[:3, :7].tobytes(),
                                   [b"* IM Tools", b"pixel n8", b"name x",
                                    b"height 3", b"width 7"]))
    out["imt_width_not_a_number.imt"] = ("imt_refused", imt_file(
        2, 2, bytes(4), [b"width abc", b"height 2", b"pixel n8"]))
    out["imt_no_form_feed.imt"] = ("imt_refused", b"width 2\nheight 2\n"
                                   b"pixel n8\n\n" + bytes(4))
    out["imt_cut_short_8x5.imt"] = ("imt_refused", imt_file(
        8, 5, g.tobytes()[:-1]))

    g = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    out["iptc_raw_L_7x5.iim"] = ("iptc", iptc_file(g.tobytes(), 7, 5))
    out["iptc_raw_rgb_band1_7x5.iim"] = ("iptc", iptc_file(
        g.tobytes(), 7, 5, 3, 1, band=1, chunk=6,
        fields=[iptc_field(2, 5, b"title"), iptc_field(2, 25, b"k1"),
                iptc_field(2, 25, b"k2")]))
    out["iptc_raw_cmyk_band3_7x5.iim"] = ("iptc", iptc_file(
        g.tobytes(), 7, 5, 4, 1, band=3))
    # field() reads 5 bytes before a long size's own bytes: the size is
    # read one byte late, and the data with it
    out["iptc_long_size_read_a_byte_late.iim"] = ("iptc_refused", iptc_file(
        g.tobytes(), 7, 5, 4, 1, band=3, chunk=40000))
    out["iptc_raw_rgb_no_band_field_7x5.iim"] = ("iptc", iptc_file(
        g.tobytes(), 7, 5, 3, 2))
    out["iptc_raw_rgb_band_minus1_7x5.iim"] = ("iptc", iptc_file(
        g.tobytes(), 7, 5, 3, 1, band=-1))
    jg = _grey_jpeg(rng.integers(0, 256, (9, 10)))
    out["iptc_jpeg_L_10x9.iim"] = ("iptc", iptc_file(jg, 10, 9,
                                                     compression=5))
    out["iptc_jpeg_rgb_band2_10x9.iim"] = ("iptc", iptc_file(
        jg, 10, 9, 3, 1, 5, band=2, chunk=100))
    rgbj = _pillow(PILImage.fromarray(rng.integers(0, 256, (6, 8, 3)).astype(
        np.uint8)), "JPEG", quality=85)
    out["iptc_jpeg_of_rgb_in_L_8x6.iim"] = ("iptc", iptc_file(
        rgbj, 99, 1, compression=5))
    out["iptc_raw_extra_data_7x5.iim"] = ("iptc", iptc_file(
        g.tobytes() + bytes(10), 7, 5))
    out["iptc_unknown_compression.iim"] = ("iptc_refused", iptc_file(
        g.tobytes(), 7, 5, compression=2))
    out["iptc_field_size_byte_133.iim"] = ("iptc_refused", iptc_file(
        g.tobytes(), 7, 5, fields=[bytes((0x1C, 2, 5, 133, 0))]))
    out["iptc_junk_after_data.iim"] = ("iptc_refused", iptc_file(
        g.tobytes(), 7, 5, tail=b"junk!"))
    out["iptc_band_past_rgb.iim"] = ("iptc_refused", iptc_file(
        g.tobytes(), 7, 5, 3, 1, band=4))
    out["iptc_rgb_jpeg_as_band.iim"] = ("iptc_refused", iptc_file(
        rgbj, 8, 6, 3, 1, 5, band=0))
    out["iptc_raw_cut_short.iim"] = ("iptc_refused", iptc_file(
        g.tobytes()[:-1], 7, 5))
    crop = texels[:SCIENCE_CROP, :SCIENCE_CROP, 1]
    out[SCIENCE_CHIP] = ("iptc", iptc_file(
        _grey_jpeg(crop), SCIENCE_CROP, SCIENCE_CROP, 3, 1, 5, band=2))
    return out


SCIENCE_DIR = os.path.join(OUT, "science")
SCIENCE_SEED = 28


def write_science() -> None:
    """Write science_fixtures (of BIG's texels) into SCIENCE_DIR, with its
    manifest; the files JAX's loader refuses are listed with the name of
    its error and no hash."""
    with PILImage.open(os.path.join(OUT, BIG)) as img:
        texels = np.asarray(img.convert("RGB"))
    files = _write(SCIENCE_DIR, science_fixtures(
        np.random.default_rng(SCIENCE_SEED), texels))
    _manifest(os.path.join(SCIENCE_DIR, "manifest.json"), files,
              COMMAND + " --science", SCIENCE_SEED)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(SCIENCE_DIR, REPO)}")

X11_DIR = os.path.join(OUT, "x11_pnm")


def write_x11() -> None:
    """Write x11_pnm_fixtures and fault_fixtures into X11_DIR, with its
    manifest (the main one's 1 MiB cap is nearly reached)."""
    made = dict(x11_pnm_fixtures(np.random.default_rng(26)))
    made.update(fault_fixtures(np.random.default_rng(126)))
    files = _write(X11_DIR, made)
    _manifest(os.path.join(X11_DIR, "manifest.json"), files)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(X11_DIR, REPO)}")


LEGACY_DIR = os.path.join(OUT, "legacy")
LEGACY_SEED = 27


def write_legacy() -> None:
    """Write legacy_fixtures (of BIG's texels) into LEGACY_DIR, with its
    manifest; the files JAX's loader refuses are listed with the name of
    its error and no hash."""
    with PILImage.open(os.path.join(OUT, BIG)) as im:
        texels = np.asarray(im.convert("RGB"))
    files = _write(LEGACY_DIR, legacy_fixtures(
        np.random.default_rng(LEGACY_SEED), texels))
    _manifest(os.path.join(LEGACY_DIR, "manifest.json"), files,
              COMMAND + " --legacy", LEGACY_SEED)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(LEGACY_DIR, REPO)}")


CORNERS_DIR = os.path.join(OUT, "jpeg_corners")
CORNERS_SEED = 29
CORNERS_OJPEG = "tiff_ojpeg_ycbcr22_tiles512x256_q85_1024.tif"
# the JPEG segment cases: (name, segments, JFIF kept, JAX's loader opens)
_SHORT_MPF = (0xB001, 4, 1, struct.pack("<I", 2)), (0xB002, 7, 20,
                                                     bytes(20))


def _xres(typ: int, count: int, value: bytes, unit=True) -> tuple:
    """An Exif segment of ResolutionUnit 2 (or none) and XResolution."""
    entries = [(0x0128, 3, 1, struct.pack("<H", 2))] if unit else []
    return exif_segment(entries + [(0x011A, typ, count, value)])


def jpeg_corner_fixtures(rng, texels: np.ndarray) -> dict:
    """The cases of JpegImagePlugin's _read_dpi_from_exif and jpeg_factory
    (_getmp) and of libtiff's old-style JPEG in tiles, in separate planes
    and of other samplings, and ThunderScan in tiles or of two samples
    (each refused where JAX's loader refuses it); and the chip path's
    tiled old-style JPEG TIFF of BIG's texels (YCbCr 2x2 at quality 85,
    512x256 tiles)."""
    out = {}
    base = _pillow(PILImage.fromarray(smooth_image(rng, 8, 8, 25.0)),
                   "JPEG", quality=90)
    seg = {
        "jpeg_mpf_short_entries_8x8.jpg": ([mpf_segment(_SHORT_MPF)], False,
                                           False),
        "jpeg_exif_xres_ascii_7_8x8.jpg": ([_xres(2, 2, b"7\0")], False,
                                           False),
        "jpeg_exif_xres_ascii_empty_8x8.jpg": ([_xres(2, 1, b"\0")], False,
                                               False),
        "jpeg_exif_xres_ascii_72_8x8.jpg": ([_xres(2, 3, b"72\0")], False,
                                            True),
        "jpeg_exif_xres_byte_8x8.jpg": ([_xres(1, 1, b"\x48")], False,
                                        False),
        "jpeg_exif_xres_undefined_zero_8x8.jpg": (
            [_xres(7, 2, b"\x48\0")], False, True),
        "jpeg_exif_xres_ascii_letter_8x8.jpg": ([_xres(2, 2, b"x\0")],
                                                False, True),
        "jpeg_exif_xres_rational_8x8.jpg": (
            [_xres(5, 1, struct.pack("<II", 72, 1))], False, True),
        "jpeg_exif_short_xres_jfif_dpi_8x8.jpg": ([_xres(2, 2, b"7\0")],
                                                  True, True),
        "jpeg_exif_short_xres_no_unit_8x8.jpg": (
            [_xres(2, 2, b"7\0", unit=False)], False, True),
        "jpeg_exif_short_xres_cut_8x8.jpg": (
            [(0xE1, _xres(2, 2, b"7\0")[1][:6 + 8 + 2 + 12])], False, True),
        # the second Exif segment's directory after the first's "Exif\0\0"
        "jpeg_exif_two_segments_8x8.jpg": (
            [(0xE1, b"Exif\0\0"), _xres(2, 2, b"7\0")], False, False),
        "jpeg_mpf_ultra_hdr_8x8.jpg": (
            [(0xE1, b"http://ns.adobe.com/xap/1.0/\0<x:xmpmeta hdrgm:"
              b"Version=\"1.0\"/>"),
             mpf_segment([(0xB001, 4, 1, struct.pack("<I", 2)),
                          (0xB002, 7, 32, mp_entries([(0, 9), (9, 9)]))])],
            False, True),
        "jpeg_mpf_ultra_hdr_short_entries_8x8.jpg": (
            [(0xE1, b"<x hdrgm:Version=\"1.0\"/>"), mpf_segment(_SHORT_MPF)],
            False, False),
        "jpeg_mpf_png_entry_8x8.jpg": (
            [mpf_segment([(0xB001, 4, 1, struct.pack("<I", 2)),
                          (0xB002, 7, 20, mp_entries([(0, 9)], fmt=1)
                           + bytes(4))])], False, True),
        "jpeg_mpf_count_rational_8x8.jpg": (
            [mpf_segment([(0xB001, 5, 1, struct.pack("<II", 2, 1)),
                          (0xB002, 7, 4, bytes(4))])], False, True),
        "jpeg_mpf_entries_ascii_8x8.jpg": (
            [mpf_segment([(0xB001, 4, 1, struct.pack("<I", 2)),
                          (0xB002, 2, 5, b"abcd\0")])], False, True),
        "jpeg_mpf_no_entries_8x8.jpg": (
            [mpf_segment([(0xB001, 4, 1, struct.pack("<I", 3))])], False,
            True),
        "jpeg_mpf_one_image_short_8x8.jpg": (
            [mpf_segment([(0xB001, 3, 1, struct.pack("<H", 1)),
                          (0xB002, 7, 15, bytes(15))])], False, False),
        "jpeg_mpf_big_endian_short_8x8.jpg": (
            [mpf_segment([(0xB001, 4, 1, struct.pack(">I", 2)),
                          (0xB002, 7, 24, mp_entries([(0, 9)], ">")
                           + bytes(8))], ">")], False, False),
        "jpeg_mpf_bad_header_8x8.jpg": (
            [(0xE2, b"MPF\0XX*\0" + bytes(8))], False, True),
    }
    for name, (segments, jfif, opens) in seg.items():
        data = jpeg_with_segments(base, segments, jfif=jfif)
        if jfif:                                # density unit 1 (dots/inch)
            data = data[:13] + b"\x01" + data[14:]
        out[name] = ("jpeg" if opens else "jpeg_refused", data)
    # an MPO: Pillow's writer, two frames that differ
    a, b = smooth_image(rng, 16, 24, 20.0), smooth_image(rng, 16, 24, 20.0)
    buf = io.BytesIO()
    PILImage.fromarray(a).save(buf, "MPO", save_all=True,
                               append_images=[PILImage.fromarray(b)],
                               quality=90)
    out["mpo_two_frames_24x16.mpo"] = ("mpo", buf.getvalue())
    short = jpeg_with_segments(base, [mpf_segment(_SHORT_MPF)])
    out["blp1_jpeg_mpf_short_8x8.blp"] = ("blp", blp_file(
        1, 8, 8, short[160:], compression=0, jpeg_header=short[:160]))
    exif = jpeg_with_segments(base, [_xres(2, 2, b"7\0")])
    out["blp1_jpeg_exif_short_xres.blp"] = ("blp_refused", blp_file(
        1, 8, 8, exif[120:], compression=0, jpeg_header=exif[:120]))
    grey = jpeg_with_segments(_grey_jpeg(rng.integers(0, 256, (9, 10))),
                              [mpf_segment(_SHORT_MPF)])
    out["iptc_jpeg_mpf_short.iim"] = ("iptc_refused", iptc_file(
        grey, 10, 9, compression=5))

    px = smooth_image(rng, 40, 48, 25.0)
    tiles = {
        "grey_tiles_jif_48x40": (px[..., :1], 1, dict(form="jif",
                                                       tile=(16, 16))),
        "grey_tiles_tables_across_48x40": (px[..., :1], 1, dict(
            form="tables", tile=(16, 16))),
        "ycbcr22_tiles_stream_48x40": (px, 6, dict(subsampling=2,
                                                    tile=(32, 16))),
        "ycbcr21_tiles_tables_across_48x40": (px, 6, dict(
            subsampling=1, form="tables", tile=(16, 16))),
        "ycbcr11_tiles_jif_mm_48x40": (px, 6, dict(form="jif", order=">",
                                                    tile=(16, 32))),
        "ycbcr_planes_stream_48x40": (px, 6, dict(
            planar=2, sampling=((1, 1),) * 3)),
        "ycbcr_planes_jif_strips_mm_48x40": (px, 6, dict(
            planar=2, sampling=((1, 1),) * 3, form="jif",
            rows_per_strip=8, order=">")),
        "ycbcr_planes_tiles_48x40": (px, 6, dict(
            planar=2, sampling=((1, 1),) * 3, tile=(16, 16))),
        "ycbcr12_stream_48x40": (px, 6, dict(sampling=((1, 2), (1, 1),
                                                         (1, 1)))),
        "ycbcr41_strips_48x40": (px, 6, dict(
            sampling=((4, 1), (1, 1), (1, 1)), rows_per_strip=8)),
        "ycbcr42_tiles_48x40": (px, 6, dict(
            sampling=((4, 2), (1, 1), (1, 1)), tile=(32, 16))),
        "ycbcr22_tag21_48x40": (px, 6, dict(
            sampling=((2, 2), (1, 1), (1, 1)), subsampling_tag=(2, 1))),
        "ycbcr21_tag22_strips_48x40": (px, 6, dict(
            sampling=((2, 1), (1, 1), (1, 1)), subsampling_tag=(2, 2),
            rows_per_strip=16)),
        "ycbcr22_no_tag_tiles_48x40": (px, 6, dict(
            sampling=((2, 2), (1, 1), (1, 1)), subsampling_tag=(),
            tile=(16, 16))),
    }
    refused = {
        "ycbcr_planes_sampled22_48x40": (px, 6, dict(
            planar=2, sampling=((2, 2), (1, 1), (1, 1)))),
        "sampled31_48x40": (px, 6, dict(sampling=((3, 1), (1, 1),
                                                   (1, 1)))),
        "chroma_up_11_22_22_48x40": (px, 6, dict(
            sampling=((1, 1), (2, 2), (2, 2)))),
        "mixed_22_11_21_tiles_48x40": (px, 6, dict(
            sampling=((2, 2), (1, 1), (2, 1)), tile=(16, 16))),
    }
    for kind, cases in (("tiff", tiles), ("tiff_refused", refused)):
        for name, (img, photo, kw) in cases.items():
            out[f"tiff_ojpeg_{name}.tif"] = (kind, ojpeg_tiff(
                img, photo, quality=85, **kw))
    four = (np.cumsum(rng.integers(-2, 3, (32, 32)), 1) % 16).astype(
        np.uint8)
    out["tiff_thunderscan_tiles_32x32.tif"] = ("tiff_refused", tiff_file(
        four[..., None], 4, 1, compression=32809, tile=(16, 16),
        raw_strips=thunder_tiles(four, (16, 16), rng)))
    out["tiff_thunderscan_two_samples_32x32.tif"] = ("tiff_refused",
                                                     tiff_file(
        np.stack([four, four], -1), 4, 1, compression=32809,
        raw_strips=[b"".join(thunder_row(r, rng) for r in np.repeat(
            four, 2, axis=1))]))
    out[CORNERS_OJPEG] = ("tiff", ojpeg_tiff(texels, 6, subsampling=2,
                                             quality=85, tile=(512, 256)))
    return out


def write_jpeg_corners() -> None:
    """Write jpeg_corner_fixtures (of BIG's texels) into CORNERS_DIR, with
    its manifest; the files JAX's loader refuses are listed with the name
    of its error and no hash."""
    with PILImage.open(os.path.join(OUT, BIG)) as im:
        texels = np.asarray(im.convert("RGB"))
    files = _write(CORNERS_DIR, jpeg_corner_fixtures(
        np.random.default_rng(CORNERS_SEED), texels))
    _manifest(os.path.join(CORNERS_DIR, "manifest.json"), files,
              COMMAND + " --jpeg-corners", CORNERS_SEED)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(CORNERS_DIR, REPO)}")


TAILS_DIR = os.path.join(OUT, "jpx_lab_iptc")
TAILS_SEED = 30
TAILS_CROP = 256
TAILS_CHIP = f"iptc_png_green_band1_crop{TAILS_CROP}.iim"


def _lab_colr(size: int) -> bytes:
    """A colr box's body of CIELab (method 1, EnumCS 14) of size bytes,
    its parameters (past the 7 bytes of the method, precedence,
    approximation and EnumCS) counting up from 1."""
    return (struct.pack(">BBBI", 1, 0, 0, 14)
            + bytes(range(1, 34)))[:size]


def _saved(im, fmt: str, **kw) -> bytes:
    """Pillow's save of im as fmt, its deprecation warnings quiet."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _pillow(im, fmt, **kw)


def tails_fixtures(rng, texels: np.ndarray) -> dict:
    """The last tails of Pillow's plugins: JP2 files with a CIELab colr
    box of each size (alone, and before an sYCC colr), JPX files (the jpx
    brand, rreq, jpch, jplh, cgrp, ftbl, dtbl, asoc, two codestreams, colr
    methods and EnumCS 19-25), IM files of type LAB, IPTC streams whose
    band images are files of each format and mode Pillow merges (or
    refuses to, or dies on: "_dies", refused by the port), planar
    old-style JPEG TIFFs whose plane 1 SOS libtiff cannot take; and
    TAILS_CHIP, an RGB IPTC stream whose band 1 is a PNG of the texels'
    (BIG's) top-left crop's green, for chip_smoke.py phase 18c."""
    out = {}
    rgb = smooth_image(rng, 6, 9, 25.0)

    def codestream(img, **kw):
        return _pillow(PILImage.fromarray(img), "JPEG2000", no_jp2=True,
                       **kw)

    cs = {"rgb": codestream(rgb), "grey": codestream(rgb[..., 1]),
          "rgba": codestream(np.dstack([rgb, rgb[..., :1]]))}
    for size in (7, 11, 34, 35, 39):
        out[f"jp2_lab_colr{size}_rgb_9x6.jp2"] = ("jp2", jp2_file(
            cs["rgb"], colr=(_lab_colr(size),)))
    out["jp2_lab_colr11_then_sycc_9x6.jp2"] = ("jp2", jp2_file(
        cs["rgb"], colr=(_lab_colr(11), (1, 18))))
    out["jp2_lab_colr6_9x6.jp2"] = ("jp2_refused", jp2_file(
        cs["rgb"], colr=(_lab_colr(6),)))
    for kind in ("grey", "rgba"):
        out[f"jp2_lab_colr11_{kind}_9x6.jp2"] = ("jp2", jp2_file(
            cs[kind], colr=(_lab_colr(11),)))
    jpx = dict(brand=b"jpx ", compat=(b"jpx ", b"jp2 "))
    rreq = box(b"rreq", bytes((1, 0x80, 0)) + bytes(4))
    colr = {n: box(b"colr", struct.pack(">BBBI", 1, 0, 0, n))
            for n in (16, 17, 18)}
    ftbl = box(b"ftbl", box(b"flst", struct.pack(">HHIIH", 1, 0, 0, 0, 0)))
    cases = {
        "brand": ({}, "jpx"), "only_jpx_compat": (dict(compat=(b"jpx ",)),
                                                  "jpx"),
        "rreq": (dict(before=[rreq]), "jpx"),
        "jpch_colr17_after": (dict(after=[box(b"jpch", colr[17])]), "jpx"),
        "jpch_pclr_before": (dict(before=[box(b"jpch", box(
            b"pclr", struct.pack(">HB", 2, 3) + bytes(9)))]), "jpx"),
        "jpch_cdef_after": (dict(after=[box(b"jpch", box(
            b"cdef", struct.pack(">HHHH", 1, 0, 0, 1)))]), "jpx"),
        "jplh_cgrp_before": (dict(before=[box(b"jplh", box(
            b"cgrp", colr[18]))]), "jpx"),
        "cgrp_inside": (dict(inside=[box(b"cgrp", colr[18])]), "jpx"),
        "asoc_lbl_xml": (dict(after=[box(b"asoc", box(b"lbl ", b"name")
                                         + box(b"xml ", b"<a/>"))]), "jpx"),
        "ftbl": (dict(after=[ftbl]), "jpx"),
        "ftbl_no_jp2c": (dict(after=[ftbl], jp2c=False), "jpx_refused"),
        "dtbl": (dict(after=[box(b"dtbl", struct.pack(">H", 1) + box(
            b"url ", bytes(4) + b"a\0"))]), "jpx"),
        "two_jp2c": (dict(tail=[box(b"jp2c", cs["grey"])]), "jpx"),
        "jpch_no_jp2h": (dict(before=[box(b"jpch", colr[17])],
                              jp2h=False), "jpx_refused"),
        "jplh_no_jp2h": (dict(after=[box(b"jplh", colr[17])], jp2h=False),
                         "jpx_refused"),
        "colr_method0_then_sycc": (dict(colr=(struct.pack(
            ">BBBI", 0, 0, 0, 16), (1, 18))), "jpx"),
        "colr_method3_then_sycc": (dict(colr=(struct.pack(
            ">BBB", 3, 0, 0) + bytes(8), (1, 18))), "jpx"),
        "colr_method4_then_sycc": (dict(colr=(struct.pack(
            ">BBB", 4, 0, 0), (1, 18))), "jpx"),
        "colr_method5_then_sycc": (dict(colr=(struct.pack(
            ">BBB", 5, 0, 0) + bytes(12), (1, 18))), "jpx"),
        "icc_then_sycc": (dict(colr=((2, bytes(16)), (1, 18))), "jpx"),
    }
    for name, (kw, kind) in cases.items():
        out[f"jpx_{name}_rgb_9x6.jp2"] = (kind, jp2_file(
            cs["rgb"], **dict(jpx, **kw)))
    for comps in ("grey", "rgb", "rgba"):
        for enumcs in range(19, 26):
            out[f"jpx_enumcs{enumcs}_{comps}_9x6.jp2"] = (
                "jpx_refused" if enumcs == 24 else "jpx",
                jp2_file(cs[comps], colr=((1, enumcs),), **jpx))
    # IM of type LAB: all 256 L values, alone, after a type line that left
    # the L layout, with Luts of grey and of colour, after one that left
    # another layout (no unpacker: refused)
    ramp = np.arange(256, dtype=np.uint8).tobytes()
    colour = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    for name, (kind, lut) in {
            "lab": (b"LAB", None),
            "lab_lut_grey": (b"LAB", np.tile(np.arange(256, dtype=np.uint8),
                                             3).tobytes()),
            "lab_lut_colour": (b"LAB", colour),
            "greyscale_then_lab": (b"Greyscale image\r\nImage type: LAB",
                                   None)}.items():
        out[f"im_{name}_16x16.im"] = ("im", im_file(kind, 16, 16, ramp,
                                                    lut=lut))
    out["im_rgb_then_lab_16x16.im"] = ("im_refused", im_file(
        b"RGB image\r\nImage type: LAB", 16, 16, ramp * 3))
    # IPTC band images: Pillow's saves of each format and mode, nested
    w, h = 6, 5
    grey = smooth_image(rng, h, w, 25.0)[..., 1]
    pal = PILImage.fromarray((grey % 7).astype(np.uint8)).convert("P")
    pal.putpalette(rng.integers(0, 256, 21).astype(np.uint8).tobytes())
    bits = PILImage.fromarray(grey).convert("1")
    i16 = PILImage.fromarray(rng.integers(0, 65536, (h, w)).astype(
        np.uint16))
    l8 = PILImage.fromarray(grey)
    f32 = PILImage.fromarray(rng.uniform(-5, 300, (h, w)).astype(
        np.float32))
    i32 = PILImage.fromarray(rng.integers(-5, 70000, (h, w)).astype(
        np.int32))
    nested = {   # name: (nested file, IPTC layers, band, kind)
        "png_p_band0": (_saved(pal, "PNG"), 3, 0, "iptc"),
        "png_1_band0": (_saved(bits, "PNG"), 3, 0, "iptc"),
        "png_i16_band0": (_saved(i16, "PNG"), 3, 0, "iptc"),
        "png_l_band1": (_saved(l8, "PNG"), 3, 1, "iptc"),
        "png_p_band1": (_saved(pal, "PNG"), 3, 1, "iptc_refused"),
        "bmp_p_band0": (_saved(pal, "BMP"), 3, 0, "iptc"),
        "bmp_l_band1": (_saved(l8, "BMP"), 3, 1, "iptc"),
        "gif_p_band0": (_saved(pal, "GIF"), 3, 0, "iptc"),
        "gif_1_band2": (_saved(bits, "GIF"), 3, 2, "iptc"),
        "tiff_l_band2": (_saved(l8, "TIFF"), 3, 2, "iptc"),
        "tiff_p_band0": (_saved(pal, "TIFF"), 3, 0, "iptc"),
        "tiff_i16b_band0": (_saved(i16.convert("I;16B"), "TIFF"), 3, 0,
                            "iptc"),
        "tga_p_band0": (_saved(pal, "TGA"), 3, 0, "iptc"),
        "tga_l_band1": (_saved(l8, "TGA"), 3, 1, "iptc"),
        "sgi_l_band1": (_saved(l8, "SGI"), 3, 1, "iptc"),
        "pcx_p_band0": (_saved(pal, "PCX"), 3, 0, "iptc"),
        "msp_1_band0": (_saved(bits, "MSP"), 3, 0, "iptc"),
        "xbm_1_cmyk_band0": (_saved(bits, "XBM"), 4, 0, "iptc"),
        "ppm_1_band0": (_saved(bits, "PPM"), 3, 0, "iptc"),
        "im_p_band0": (_saved(pal, "IM"), 3, 0, "iptc"),
        "im_i16l_band0": (_saved(i16.convert("I;16L"), "IM"), 3, 0,
                          "iptc"),
        "jp2_i16_band0": (_saved(i16, "JPEG2000"), 3, 0, "iptc"),
        "dds_l_cmyk_band3": (_saved(l8, "DDS"), 4, 3, "iptc"),
        "qoi_rgb_band0": (_saved(l8.convert("RGB"), "QOI"), 3, 0,
                          "iptc_refused"),
        "tiff_f_band0": (_saved(f32, "TIFF"), 3, 0, "iptc_dies"),
        "tiff_i_band0": (_saved(i32, "TIFF"), 3, 0, "iptc_dies"),
        "spider_band0": (_saved(f32, "SPIDER"), 3, 0, "iptc_dies"),
        "tiff_f_band1": (_saved(f32, "TIFF"), 3, 1, "iptc_refused"),
        "l_of_tiff_f": (_saved(f32, "TIFF"), 1, None, "iptc_refused"),
        "l_of_tiff_i16b": (_saved(i16.convert("I;16B"), "TIFF"), 1, None,
                           "iptc_refused"),
        "l_of_tiff_i": (_saved(i32, "TIFF"), 1, None, "iptc"),
        "mcidas_overlapping_band0": (mcidas_file(grey, prefix=2,
                                                 words={14: 0}), 3, 0,
                                     "iptc_refused"),
    }
    for name, (data, layers, band, kind) in nested.items():
        out[f"iptc_{name}.iim"] = (kind, iptc_file(
            data, w, h, layers=layers, component=int(layers > 1),
            compression=5, band=band))
    # planar old-style JPEG TIFFs whose plane 1 SOS is corrupt, cut or
    # names another component
    px = smooth_image(rng, 40, 48, 25.0)
    planes = dict(planar=2, sampling=((1, 1),) * 3, form="jif",
                  rows_per_strip=8, quality=85)

    def damaged(how, kw):
        b = bytearray(ojpeg_tiff(px, 6, **dict(planes, **kw)))
        at = [i for i in range(len(b) - 1) if b[i:i + 2] == b"\xff\xda"]
        if how == "length":
            b[at[1] + 3] ^= 0x10
        elif how == "count":
            b[at[1] + 4] = 3
        elif how == "component":
            b[at[1] + 5] = 9
        else:                                    # both later SOS markers
            for i in at[1:]:
                b[i + 1] = 0
        return bytes(b)

    for name, (how, kw, kind) in {
            "length_strips": ("length", {}, "tiff"),
            "count_tiles": ("count", dict(tile=(16, 16), rows_per_strip=None),
                            "tiff"),
            "count_strips_stream": ("count", dict(form="stream"), "tiff"),
            "missing_two_strips": ("missing", dict(rows_per_strip=24),
                                   "tiff"),
            "missing_strips": ("missing", {}, "tiff_refused"),
            "component_strips": ("component", {}, "tiff_refused"),
            "component_one_tile_row": ("component", dict(
                tile=(16, 48), rows_per_strip=None), "tiff")}.items():
        out[f"tiff_ojpeg_planes_plane1_sos_{name}_48x40.tif"] = (
            kind, damaged(how, kw))
    crop = texels[:TAILS_CROP, :TAILS_CROP, 1]
    out[TAILS_CHIP] = ("iptc", iptc_file(
        _pillow(PILImage.fromarray(np.ascontiguousarray(crop)), "PNG"),
        TAILS_CROP, TAILS_CROP, layers=3, component=1, compression=5,
        band=1))
    return out


def write_tails() -> None:
    """Write tails_fixtures (of BIG's texels) into TAILS_DIR, with its
    manifest; the files JAX's loader refuses are listed with the name of
    its error and no hash, those on which its process dies with
    "died"."""
    with PILImage.open(os.path.join(OUT, BIG)) as im:
        texels = np.asarray(im.convert("RGB"))
    files = _write(TAILS_DIR, tails_fixtures(
        np.random.default_rng(TAILS_SEED), texels))
    _manifest(os.path.join(TAILS_DIR, "manifest.json"), files,
              COMMAND + " --tails", TAILS_SEED)
    print(f"{len(files)} fixtures, {sum(x['bytes'] for x in files)} bytes, "
          f"in {os.path.relpath(TAILS_DIR, REPO)}")


def jax_dies(path: str) -> bool:
    """Whether the process of JAX's load_image of the file dies (by a
    signal), in a process of its own."""
    run = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from cge_tpu.scene.image_io import load_image; "
         "load_image(sys.argv[2])", REPO, path],
        capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return run.returncode < 0


def jax_pixels(path: str) -> np.ndarray:
    """cge_tpu's load_image of the file, quantised to u8 [H, W, 3]."""
    from cge_tpu.scene.image_io import load_image

    return np.rint(load_image(path).pixels * 255.0).astype(np.uint8)


def sha256(u8: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(u8, np.uint8)
                          .tobytes()).hexdigest()


def _write(directory: str, made: dict) -> list:
    """Write each (kind, bytes) of made into directory; the manifest's
    entries, with JAX's pixels' hashes."""
    os.makedirs(directory, exist_ok=True)
    files = []
    for name, (kind, data) in made.items():
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        if kind.endswith("_dies"):
            # JAX's process dies: the port must refuse the file
            if not jax_dies(path):
                raise AssertionError(f"{name}: JAX's loader survives it")
            files.append(dict(name=name, kind=kind, bytes=len(data),
                              shape=None, sha256=None, jax_error="died"))
            continue
        try:
            u8 = jax_pixels(path)
        except Exception as e:
            # a "_refused" kind: JAX's loader raises, and so must the port
            if not kind.endswith("_refused"):
                raise
            files.append(dict(name=name, kind=kind, bytes=len(data),
                              shape=None, sha256=None,
                              jax_error=type(e).__name__))
            continue
        if kind.endswith("_refused"):
            raise AssertionError(f"{name}: JAX's loader decodes it")
        files.append(dict(name=name, kind=kind, bytes=len(data),
                          shape=list(u8.shape), sha256=sha256(u8)))
    return files


def _manifest(path: str, files: list, command: str = COMMAND,
              seed: int = 16) -> None:
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    meta = dict(pillow=PILImage.__version__,
                libjpeg_turbo=features.version("libjpeg_turbo"),
                openjpeg=features.version("jpg_2000"),
                commit=commit, command=command, seed=seed, files=files)
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def main(argv=()) -> int:
    """Every folder, or with --legacy only tests/torch_textures/legacy/,
    with --science only tests/torch_textures/science/, with --jpeg-corners
    only tests/torch_textures/jpeg_corners/, with --tails only
    tests/torch_textures/jpx_lab_iptc/."""
    if "--tails" in argv:
        write_tails()
        return 0
    if "--jpeg-corners" in argv:
        write_jpeg_corners()
        return 0
    if "--legacy" in argv:
        write_legacy()
        return 0
    if "--science" in argv:
        write_science()
        return 0
    made = fixtures()
    files = _write(OUT, made)
    _manifest(MANIFEST, files)
    total = sum(x["bytes"] for x in files)
    print(f"{len(files)} fixtures, {total} bytes, in "
          f"{os.path.relpath(OUT, REPO)} ({BIG}: "
          f"{next(x['bytes'] for x in files if x['name'] == BIG)} bytes)")
    texels = np.asarray(PILImage.open(io.BytesIO(made[BIG][1])).convert(
        "RGB"))
    chip = _write(J2K_CHIP_DIR, j2k_chip_files(texels))
    _manifest(os.path.join(J2K_CHIP_DIR, "manifest.json"), chip)
    print(f"{len(chip)} chip-path files, "
          f"{sum(x['bytes'] for x in chip)} bytes, in "
          f"{os.path.relpath(J2K_CHIP_DIR, REPO)}")
    write_tail()
    write_x11()
    write_legacy()
    write_science()
    write_jpeg_corners()
    write_tails()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
