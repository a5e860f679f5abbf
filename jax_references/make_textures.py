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
JPEG at quality 90, all from seeded numpy images. It is the JAX side:
Pillow writes the JPEGs and some TGA, PNM and GIF files, the encoders
below write the rest (PNGs with the port's row filters), and the JAX
package's `cge_tpu.scene.image_io.load_image` (Pillow's
`convert("RGB")`) gives the reference pixels.

manifest.json records each file's kind, format, shape and the SHA-256 of
JAX's pixels quantised to u8 ([H, W, 3] C order), with the Pillow and
libjpeg-turbo versions, the commit and the command. The port's tests hold
its decoders to JAX's pixels on every file; chip_smoke.py holds them to
the manifest's hashes on the card's machine, which has no Pillow.

    JAX_PLATFORMS=cpu python3 jax_references/make_textures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402
from PIL import features  # noqa: E402

from cge_tpu_torch.scene.image_io import _chunk, _filter_rows  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_textures")
MANIFEST = os.path.join(OUT, "manifest.json")
BIG = "jpeg_progressive_420_q90_1024.jpg"
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


def jax_pixels(path: str) -> np.ndarray:
    """cge_tpu's load_image of the file, quantised to u8 [H, W, 3]."""
    from cge_tpu.scene.image_io import load_image

    return np.rint(load_image(path).pixels * 255.0).astype(np.uint8)


def sha256(u8: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(u8, np.uint8)
                          .tobytes()).hexdigest()


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    files = []
    for name, (kind, data) in fixtures().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        u8 = jax_pixels(path)
        files.append(dict(name=name, kind=kind, bytes=len(data),
                          shape=list(u8.shape), sha256=sha256(u8)))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    meta = dict(pillow=PILImage.__version__,
                libjpeg_turbo=features.version("libjpeg_turbo"),
                commit=commit, command=COMMAND, seed=16, files=files)
    with open(MANIFEST, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    total = sum(x["bytes"] for x in files)
    print(f"{len(files)} fixtures, {total} bytes, in "
          f"{os.path.relpath(OUT, REPO)} ({BIG}: "
          f"{next(x['bytes'] for x in files if x['name'] == BIG)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
