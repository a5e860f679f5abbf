"""Textures without Pillow (counterpart of cge_tpu/scene/image_io.py):
PNG, BMP, JPEG, GIF, TGA, PNM, PSD, TIFF, WebP, DDS, JPEG 2000, and the
formats of model and game asset sets: SGI, PCX and DCX, QOI, ICO and CUR,
ICNS, BLP, FTEX and Sun raster.

`load_image` decodes a texture as the JAX package's loader does, whose
`convert("RGB")` through Pillow is the reference: forced RGB, u8 / 255 as
float32, row 0 the top of the image (the reference's stb_image,
framework/src/image.cpp:22-34, which opens the first seven formats and
HDR and PIC besides). The format comes from the file's first bytes, never
its name, tried in the order of Pillow's plugins (`format_of`); where a
format's test takes a file whose header its plugin cannot open
(native.NotOpened), the next format is tried, as Image.open does
(`decode_image`):

  PNG   every bit depth of every colour type (1, 2, 4 and 8-bit grey and
        palette, 16-bit grey, grey + alpha, RGB and RGBA), plain or Adam7
        interlaced, any row filter; inflated with zlib, the filters undone
        in the native library, the samples unpacked in numpy. Pillow's
        conversions: 1-, 2- and 4-bit grey scaled by 255, 85 and 17;
        16-bit grey saturated at 255; the other 16-bit samples keep their
        high byte; alpha and tRNS dropped; a palette index past the PLTE
        chunk's end is black. Pillow's checks of the chunks before the
        first IDAT (their CRCs and type names) are followed; a zlib
        stream cut after the last scanline decodes.
  BMP   1-, 4- and 8-bit palette (also RLE8 and RLE4), 16-bit 5-5-5 and
        bitfields, 24-bit, 32-bit plain and bitfields; header sizes 12
        (OS/2 core), 40, 52, 56, 64, 108 and 124; bottom-up or top-down
        rows (`decode_bmp`); a bare device-independent bitmap (DIB) too
        (`decode_dib`, which ICO and CUR entries share).
  JPEG  every kind Pillow opens, as libjpeg-turbo decodes it: Huffman or
        arithmetic, sequential, progressive (smoothed where scans leave
        coefficients unrefined) or lossless, 8-bit, grey, YCbCr, RGB,
        CMYK or YCCK at every whole sampling (scene/jpeg.py and the
        native library's cge_jpeg.cpp).
  GIF   the first frame, every colour-table case, interlaced or not, at
        its offset on the logical screen (scene/gif.py).
  PSD   the merged image, raw or PackBits, in bitmap, grey, indexed, RGB
        (A), CMYK, multichannel and duotone (scene/psd.py).
  PNM   P1 to P6, plain and binary, at any maxval (scene/pnm.py).
  TIFF  the first IFD, II or MM, classic or BigTIFF, strips or tiles,
        either planar configuration, raw, LZW, Deflate, PackBits, LZMA or
        ZSTD with predictors 2 and 3, CCITT RLE, Group 3 and Group 4, and
        JPEG, in every mode of Pillow's table that convert("RGB") takes
        but LAB, YCbCr through libtiff's RGBA path (scene/tiff.py); old-
        style JPEG, WebP in TIFF, SGILog and ThunderScan raise.
  WebP  the first frame: lossless VP8L, lossy VP8 with or without ALPH,
        still or animated, as libwebp decodes it (scene/webp.py).
  DDS   the first surface: uncompressed RGB masks, luminance, 8-bit
        palette, DX10 R8G8B8A8, and BC1 to BC5, BC5 signed, BC6H (UF16
        and SF16) and BC7 blocks, as Pillow's DdsImagePlugin and BCn
        decoder give them (scene/dds.py).
  JPEG 2000  J2K codestreams and JP2 files as OpenJPEG 2.5.4 under Pillow
        decodes them: 5/3 and 9/7, layers, every progression order and POC,
        tiles and tile-parts, precincts, every code-block style, ROI,
        PPT / PPM, subsampled components, 1 to 16 bits, palettes, CMYK and
        sYCC (scene/jpeg2000.py, the codestream in the native library's
        cge_j2k.cpp); HTJ2K and Part 2 codestreams raise.
  TGA   colour-mapped, true-colour and grey, raw or run-length, in each
        orientation (scene/tga.py); TGA has no signature, so it is tried
        by Pillow's test of its header, in its place in Pillow's order.
  SGI   raw or run-length, grey, RGB and RGBA at 8 or 16 bits
        (scene/sgi.py).
  PCX   1 bit in 1, 2 or 4 planes, 8-bit grey or palette, RGB in 3
        planes; DCX's first page (scene/pcx.py).
  QOI   RGB and RGBA (scene/qoi.py).
  ICO   the entry Pillow picks, a PNG or a bitmap; CUR's (scene/ico.py).
  ICNS  the largest icon: a PNG or JPEG 2000 entry, or run-length colour
        (scene/icns.py).
  BLP   BLP1 JPEG and palettes, BLP2 palettes and DXT1 / DXT3 / DXT5
        through the plugin's own decoders (scene/blp.py).
  FTEX  DXT1 and raw RGB (scene/ftex.py).
  Sun   raster at 1, 4, 8, 24 and 32 bits, with colour maps, raw or
        run-length (scene/sun.py).
The byte-serial parts of SGI, PCX, QOI, Sun raster and ICNS run in the
native library's cge_raster.cpp.

Any other format (GBR, AVIF, Radiance HDR, OpenEXR, PAM, PFM, ...) raises
a ValueError that names it, as does a truncated or corrupt
file. `png_bytes` and `write_png` write
8-bit PNGs, each row with a chosen filter. `write_bmp` writes the CLI's
24-bit BMP byte for byte as the JAX package does, and `read_bmp` reads any
BMP that `decode_bmp` reads.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import (blp, dds, ftex, gif, icns, ico, jpeg,
                                 jpeg2000, pcx, pnm, psd, qoi, sgi, sun, tga,
                                 tiff, webp)

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}
# colour type -> the bit depths the PNG spec allows it
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@dataclasses.dataclass
class Image:
    """framework/include/framework/image.h:11-18."""

    width: int
    height: int
    pixels: np.ndarray  # [H, W, 3] f32 in [0, 1], row 0 = top


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _samples(rows: np.ndarray, width: int, depth: int, ch: int):
    """Unfiltered rows [h, stride] -> the samples [h, width, ch] as
    integers (uint8, or uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        px = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(-1, dtype=np.uint8)
    return px[:, :width * ch].reshape(h, width, ch)


def _pass_samples(raw: bytes, width: int, height: int, depth: int,
                  ch: int, interlace: int) -> np.ndarray:
    """The image's samples [height, width, ch] from the inflated IDAT
    stream: one pass, or Adam7's seven, each with its own filters."""
    bpp = max(1, depth * ch // 8)
    if not interlace:
        stride = (width * ch * depth + 7) // 8
        return _samples(native.png_unfilter(raw, height, stride, bpp), width,
                        depth, ch)
    out = np.zeros((height, width, ch), np.uint16 if depth == 16
                   else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                  # an empty pass has no scanlines
        stride = (pw * ch * depth + 7) // 8
        rows = native.png_unfilter(raw[pos:], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        pos += ph * (stride + 1)
    return out


def _open_chunks(data: bytes) -> None:
    """Pillow's PngImageFile._open over the chunks before the first IDAT:
    native.NotOpened where a chunk header is cut short, a chunk type is no
    four letters, digits or underscores, a CRC is cut short or wrong, or
    the IHDR names a filter method other than 0; ValueError where a chunk's
    data is cut short."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise native.NotOpened("PNG chunk header cut short")
        n, kind = struct.unpack_from(">I4s", data, pos)
        if not all(c in _CHUNK_TYPE for c in kind):
            raise native.NotOpened(f"broken PNG file (chunk {kind!r})")
        if kind in (b"IDAT", b"IEND"):
            return
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"PNG {kind.decode()} chunk is truncated")
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(
                kind + body):
            raise native.NotOpened(f"broken PNG file (bad or incomplete "
                                   f"checksum in {kind!r})")
        if kind == b"IHDR" and n >= 13:
            _png_format(struct.unpack(">IIBBBBB", body[:13]))
            if body[11]:
                raise native.NotOpened("PNG of an unknown filter category")
        pos += 12 + n


def _png_format(header: tuple) -> str:
    """The IHDR's format, as "8-bit RGB PNG"; native.NotOpened for a colour
    type, bit depth or interlace method the PNG spec has not."""
    _, _, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise native.NotOpened(f"PNG colour type {ctype} is not a PNG "
                               f"colour type")
    fmt = f"{depth}-bit {_NAMES[ctype]} PNG"
    if depth not in _DEPTHS[ctype]:
        raise native.NotOpened(f"{fmt}: the PNG spec allows {_NAMES[ctype]} "
                               f"at {_DEPTHS[ctype]} bits only")
    if interlace not in (0, 1):
        raise native.NotOpened(f"{fmt} with interlace method {interlace}: "
                               f"only none and Adam7 exist")
    return fmt


# the bytes of a chunk type Pillow's is_cid takes (regular expression \w)
_CHUNK_TYPE = frozenset(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                        b"0123456789_")


def _inflate(idat: list, need: int, fmt: str) -> bytes:
    """The IDAT stream inflated as far as the image needs, as Pillow's
    decoder reads it: a stream cut, or broken, after the last scanline's
    bytes still gives the image; ValueError where it gives fewer."""
    d = zlib.decompressobj()
    out, got = [], 0
    try:
        for chunk in idat:
            for i in range(0, len(chunk), 1 << 16):
                out.append(d.decompress(chunk[i:i + (1 << 16)]))
                got += len(out[-1])
                if got >= need:
                    return b"".join(out)
    except zlib.error as e:
        raise ValueError(f"{fmt}: the image data does not inflate ({e})") \
            from None
    raise ValueError(f"{fmt}: the image data is truncated ({got} of the "
                     f"{need} bytes of its scanlines)")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB, row 0 = top, as Pillow's
    `convert("RGB")` gives them."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    _open_chunks(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR" and len(body) >= 13:
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)
            palette = palette[:len(palette) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    fmt = _png_format(header)
    native.check_pixels(fmt, width, height)
    ch = CHANNELS[ctype]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    need = sum(ph * (1 + (pw * ch * depth + 7) // 8) for pw, ph in (
        (-(-(width - x0) // dx), -(-(height - y0) // dy))
        for x0, y0, dx, dy in passes) if pw > 0 and ph > 0)
    raw = _inflate(idat, need, fmt)
    px = _pass_samples(raw, width, height, depth, CHANNELS[ctype], interlace)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{fmt} without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)    # past the end: black
        full[:min(len(palette), 256)] = palette[:256]
        return full[px[..., 0]]
    if depth == 16:
        # Pillow: 16-bit grey ("I;16") saturates, the rest keep the high
        # byte
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(
            np.uint8)
    elif depth < 8:                               # grey at 1, 2 or 4 bits
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):                           # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _u32(data: bytes, order: str = "<") -> int:
    return struct.unpack_from(order + "I", data)[0] if len(data) >= 4 else -1


def _gbr_opens(data: bytes) -> bool:
    """GbrImagePlugin's test and header: a header size of at least 20,
    version 1 or 2, width and height above 0, depth 1 or 4, and version
    2's "GIMP" magic."""
    if len(data) < 20:
        return False
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    return (size >= 20 and version in (1, 2) and w > 0 and h > 0
            and depth in (1, 4)
            and (version == 1 or (data[20:24] == b"GIMP"
                                  and len(data) >= 28)))


def _is_pnm(data: bytes) -> bool:
    return data[:1] == b"P" and len(data) > 1 and data[1] in b"123456"


_DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)
# Pillow 12's image plugins in the order Image.open tries them (its six
# preinit plugins, then Image.ID's registration order), each with its test
# of the first bytes; the formats this loader reads have a decoder, the
# others (None) refuse the file. IM, IMT, IPTC, PCD and SPIDER, which test
# whole headers no image of the other formats has, are left out. BMP's and
# DIB's decoders are defined below, so they are called through lambdas.
_PILLOW_ORDER = (
    ("BMP", lambda d: d[:2] == b"BM", lambda d: decode_bmp(d)),
    ("DIB", lambda d: _u32(d) in _DIB_SIZES, lambda d: decode_dib(d, 0)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), gif.decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", jpeg.decode_jpeg),
    ("PNM", _is_pnm, pnm.decode_pnm),
    ("PNG", lambda d: d[:8] == SIGNATURE, decode_png),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", blp.accept, blp.decode_blp),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), None),
    ("CUR", ico.accept_cur, ico.decode_cur),
    ("PCX", pcx.accept, pcx.decode_pcx),
    ("DCX", pcx.accept_dcx, pcx.decode_dcx),
    ("DDS", lambda d: d[:4] == dds.MAGIC, dds.decode_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or _u32(d) == 0xC6D3D0C5, None),
    ("FITS", lambda d: d[:6] == b"SIMPLE", None),
    ("FLI", lambda d: len(d) >= 16 and struct.unpack_from("<H", d, 4)[0] in (
        0xAF11, 0xAF12) and struct.unpack_from("<H", d, 14)[0] in (0, 3),
     None),
    ("FTEX", ftex.accept, ftex.decode_ftex),
    ("GBR", _gbr_opens, None),
    ("GRIB", lambda d: d[:4] == b"GRIB" and len(d) >= 8 and d[7] == 1, None),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", None),
    ("JPEG 2000", jpeg2000.accept, jpeg2000.decode_jp2),
    ("ICNS", icns.accept, icns.decode_icns),
    ("ICO", ico.accept_ico, ico.decode_ico),
    ("McIdas", lambda d: d[:8] == b"\x00" * 7 + b"\x04", None),
    ("MPEG", lambda d: d[:4] == b"\x00\x00\x01\xb3", None),
    ("TIFF", lambda d: d[:4] in tiff.PREFIXES, tiff.decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), None),
    ("PIXAR", lambda d: d[:4] == b"\x80\xe8\x00\x00", None),
    ("PSD", lambda d: d[:4] == b"8BPS", psd.decode_psd),
    ("QOI", qoi.accept, qoi.decode_qoi),
    ("SGI", sgi.accept, sgi.decode_sgi),
    ("Sun raster", sun.accept, sun.decode_sun),
    ("TGA", tga.header_ok, tga.decode_tga),
    ("WebP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP",
     webp.decode_webp),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00"
     or d[:4] == b"\x01\x00\x00\x00", None),
    ("XBM", lambda d: d.lstrip()[:7] == b"#define", None),
    ("XPM", lambda d: d[:9] == b"/* XPM */", None),
    ("XV thumbnail", lambda d: d[:6] == b"P7 332", None))
# formats Pillow has no plugin for, named in the refusal
_OTHERS = ((b"#?RADIANCE", "Radiance HDR"), (b"\x76\x2f\x31\x01", "OpenEXR"),
           (b"P7", "PAM"), (b"Pf", "PFM"), (b"PF", "PFM"))
READ = tuple(n for n, _, dec in _PILLOW_ORDER if dec is not None)


def format_of(data: bytes) -> str:
    """The image format that the file's first bytes name: the first of
    Pillow's plugins, in the order Image.open tries them, whose test of the
    first bytes takes the file ("PNG", "BMP", "DIB", "JPEG", "GIF", "PNM",
    "PSD", "TIFF", "DDS", "WebP", "TGA", "SGI", "PCX", "DCX", "QOI", "ICO",
    "CUR", "ICNS", "JPEG 2000", "BLP", "FTEX" or "Sun raster" for the formats
    that decode here),
    else the name of another known format, or "unknown". TGA, which has
    no signature, comes by Pillow's test of its header. decode_image goes
    on to the next format where this one's header cannot be opened, as
    Image.open does."""
    for name, accept, _ in _PILLOW_ORDER:
        if accept(data):
            return name
    for sig, name in _OTHERS:
        if data.startswith(sig):
            return name
    return "unknown"


def _refusal(fmt: str, data: bytes) -> str:
    what = ("an image of unknown format (its first bytes are "
            f"{data[:8]!r})" if fmt == "unknown" else f"a {fmt} file")
    names = ("PNG",) + tuple(n for n in READ if n != "PNG")
    return (f"{what}, not a {', '.join(names[:-1])} or {names[-1]} file: "
            f"{fmt} images are not supported")


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> [H, W, 3] uint8 RGB, row 0 = top, the decoder
    chosen by the signature, in Pillow's order: where a format's test takes
    the file but its header cannot be opened (native.NotOpened), the next
    format whose test takes it is tried, as Image.open does. ValueError
    naming the format for any other format, and for a file its decoder
    cannot read."""
    failed = []
    for name, accept, decoder in _PILLOW_ORDER:
        if not accept(data):
            continue
        if decoder is None:
            raise ValueError(_refusal(name, data))
        try:
            return decoder(data)
        except native.NotOpened as e:
            failed.append(f"{name}: {e}")
        except ValueError as e:
            if name in str(e):                # the message names the format
                raise
            raise ValueError(f"{name}: {e}") from None
    if failed:
        raise ValueError(f"{'; '.join(failed)}: not opened, and no other "
                         f"format opens the file")
    raise ValueError(_refusal(format_of(data), data))


def load_image(path: str) -> Image:
    """stb_image-style load of a file of any format decode_image reads:
    forced RGB, u8 -> f32 / 255. ValueError naming the file and its format
    for any other, and for a file that does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        rgb = decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    h, w = rgb.shape[:2]
    return Image(width=w, height=h, pixels=rgb.astype(np.float32) / 255.0)


def to_u8(img_f32: np.ndarray) -> np.ndarray:
    """Clamp to [0, 1], scale by 255 and truncate (screen.cpp:51-56); NaN
    -> 0."""
    clamped = np.clip(np.nan_to_num(np.asarray(img_f32, np.float32),
                                    nan=0.0), 0.0, 1.0)
    return (clamped * 255.0).astype(np.uint8)


def _filter_rows(px: np.ndarray, bpp: int, filters) -> bytes:
    """Each row of px [H, stride] uint8 prefixed by its filter byte and
    filtered (PNG spec section 9)."""
    h, stride = px.shape
    out = bytearray()
    cur_i = px.astype(np.int64)
    for y in range(h):
        kind = int(filters[y % len(filters)])
        raw = cur_i[y]
        up = cur_i[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), raw[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            f = raw
        elif kind == 1:
            f = raw - left
        elif kind == 2:
            f = raw - up
        elif kind == 3:
            f = raw - (left + up) // 2
        elif kind == 4:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
            f = raw - pred
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out.append(kind)
        out += (f & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray, filters=(0,),
              palette: np.ndarray | None = None) -> bytes:
    """An 8-bit PNG file's bytes. pixels: float [H, W, 3] radiance
    (quantised as the image writer does, to_u8), or uint8 [H, W] /
    [H, W, C] with C = 1, 2, 3 or 4 samples a pixel (grey, grey + alpha,
    RGB, RGBA), or palette indices [H, W] with `palette` [K, 3] uint8.
    filters: the filter type of each row, repeated over the rows."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        px = to_u8(px)
    if px.ndim == 2:
        px = px[..., None]
    if palette is not None:
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[px.shape[2]]
    h, w, ch = px.shape
    body = zlib.compress(_filter_rows(px.reshape(h, w * ch), ch, filters))
    out = [SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [_chunk(b"IDAT", body), _chunk(b"IEND", b"")]
    return b"".join(out)


def write_png(path: str, pixels: np.ndarray, filters=(0,),
              palette: np.ndarray | None = None) -> None:
    """Write png_bytes(pixels, filters, palette) to path."""
    with open(path, "wb") as f:
        f.write(png_bytes(pixels, filters, palette))


_BMP_HEADER = "<2sIHHIIiiHHIIiiII"


def write_bmp(path: str, img_f32: np.ndarray) -> None:
    """Write a 24-bit BMP as stbi_write_bmp does (screen.cpp:49-60):
    img_f32 [H, W, 3] radiance, row 0 the top, quantised by to_u8; rows
    bottom-up in BGR order, each padded to 4 bytes."""
    u8 = to_u8(img_f32)
    h, w = u8.shape[:2]
    row_stride = (w * 3 + 3) & ~3
    data_size = row_stride * h
    header = struct.pack(_BMP_HEADER, b"BM", 54 + data_size, 0, 0, 54,
                         40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0)
    rows = np.zeros((h, row_stride), np.uint8)
    rows[:, :w * 3] = u8[::-1, :, ::-1].reshape(h, w * 3)
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def _rle_indices(data: bytes, pos: int, width: int, height: int,
                 rle4: bool) -> np.ndarray:
    """An RLE8 / RLE4 stream from data[pos:] -> palette indices [height *
    width], rows in file order, as Pillow 12's BmpRleDecoder reads them
    (the JAX loader's reference): runs past a row's end are cut, end of
    line pads the row with index 0, end of bitmap stops, a delta skips
    right + up x width pixels (set to 0) but reads its two offsets after
    two other bytes, and an absolute run of n RLE4 pixels reads n // 2
    bytes, realigned to an even offset in the file; a stream that ends, or
    stops, before the last pixel is an error."""
    out = bytearray()
    total, x, n = width * height, 0, len(data)
    while len(out) < total and pos + 2 <= n:
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                     # encoded run
            count = min(count, max(0, width - x))
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                               # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:                               # end of bitmap
            break
        elif byte == 2:                               # delta
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos:pos + 2]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                         # absolute run
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + nbytes]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 0x0F))
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            pos += pos % 2
    if len(out) < total:
        # Pillow's set_as_raw: "not enough image data"
        raise ValueError(f"BMP run-length data end after {len(out)} of "
                         f"the {total} pixels")
    return np.frombuffer(bytes(out[:total]), np.uint8)


def _channel(px: np.ndarray, mask: int) -> np.ndarray:
    """A bitfield channel of the pixels, expanded to 8 bits as Pillow's
    unpackers do (v x 255 // max, the identity for 8-bit masks)."""
    if not mask:
        return np.zeros(px.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    v = (px.astype(np.uint64) & mask) >> shift
    return (v * 255 // top).astype(np.uint8)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> [H, W, 3] uint8 RGB, row 0 = top, as Pillow's
    `convert("RGB")` gives them. ValueError naming the format for a
    BMP it cannot read (JPEG or PNG inside a BMP, other depths)."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ValueError("not a BMP file")
    return decode_dib(data, 14, struct.unpack_from("<I", data, 10)[0])


# Pillow's BmpImagePlugin: the bitfield masks it reads, by depth (32-bit:
# red, green, blue, alpha)
_BITFIELDS = {
    32: ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
         (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)),
    24: ((0xFF0000, 0xFF00, 0xFF),),
    16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def decode_dib(data: bytes, pos: int, offset: int = 0,
               halve: str = "") -> np.ndarray:
    """The device-independent bitmap whose header starts at data[pos] ->
    [H, W, 3] uint8 RGB, row 0 = top, as Pillow's BmpImageFile._bitmap
    reads it: the pixels at `offset` (a BMP file's), or where none is given
    (0: a bare DIB, an icon's or a cursor's entry) right after the header,
    its bitfield masks and its palette. halve ("ICO" or "CUR"): an entry of
    an icon or a cursor, whose height counts the AND mask's rows too, so is
    halved (after Pillow's test of an empty image for an icon, before it for
    a cursor). native.NotOpened where Pillow's plugin cannot open it: a
    header cut before its size, an empty image."""
    if pos + 4 > len(data):
        raise native.NotOpened("the bitmap header is cut before its size")
    hsize = struct.unpack_from("<I", data, pos)[0]
    if pos + hsize > len(data):
        raise ValueError(f"the {hsize}-byte bitmap header is truncated")
    info = data[pos + 4:pos + hsize]
    masks, extra = None, 0
    if hsize == 12:                                   # OS/2 core header
        w, h, _, bits = struct.unpack_from("<HHHH", info)
        comp, colors, entry, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack_from("<iiHHI", info)
        colors = struct.unpack_from("<I", info, 28)[0]
        entry, top_down = 4, h < 0
        h = abs(h)
        if comp == 3:                                 # BI_BITFIELDS
            if hsize >= 52:
                masks = struct.unpack_from("<III", info, 36)
                alpha = (struct.unpack_from("<I", info, 48)[0]
                         if hsize >= 56 else 0)
            else:
                if pos + hsize + 12 > len(data):
                    raise ValueError("the bitmap's bitfield masks are "
                                     "truncated")
                masks = struct.unpack_from("<III", data, pos + hsize)
                alpha, extra = 0, 12
    else:
        raise ValueError(f"BMP with a {hsize}-byte header: only 12, 40, "
                         f"52, 56, 64, 108 and 124 exist")
    fmt = f"{bits}-bit BMP with compression {comp}"
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{fmt}: only 1, 4, 8, 16, 24 and 32 bits a "
                         f"pixel are supported")
    if comp not in (0, 1, 2, 3) or (comp == 1 and bits != 8) or (
            comp == 2 and bits != 4) or (comp == 3 and bits < 16):
        names = {1: "RLE8", 2: "RLE4", 3: "bitfields", 4: "JPEG", 5: "PNG"}
        raise ValueError(f"{fmt} ({names.get(comp, 'unknown')}): only "
                         f"uncompressed, 8-bit RLE8, 4-bit RLE4 and 16- to "
                         f"32-bit bitfield BMPs are supported")
    if comp == 3 and (masks + (alpha,) if bits == 32 else masks) not in \
            _BITFIELDS[bits]:
        raise ValueError(f"{fmt}: bitfield masks {masks} are not a layout "
                         f"Pillow reads")
    if halve == "CUR":
        h //= 2
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    if halve == "ICO":
        h //= 2
        if not h:
            raise ValueError(f"{fmt}: an icon entry of one row, which holds "
                             f"no image rows")
    colors = colors or 1 << bits
    pal_at = pos + hsize
    if not offset:
        offset = pal_at + extra + (entry * colors if bits <= 8 else 0)
    elif offset == 14 + hsize and bits <= 8:          # as Pillow reads it
        offset += 4 * colors
    if comp in (1, 2):
        idx = _rle_indices(data, offset, w, h, comp == 2)
        px = idx.reshape(h, w)
    else:
        rows = native.raw_rows(data, offset, h, ((w * bits + 31) >> 3) & ~3,
                               (w * bits + 7) // 8, fmt)
        if bits < 8:
            px = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
            px = (px * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
                  ).sum(-1, dtype=np.uint8)[:, :w]
        elif bits == 8:
            px = rows[:, :w]
        else:
            raw = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
            px = (raw.astype(np.uint32)
                  << (8 * np.arange(bits // 8, dtype=np.uint32))).sum(
                -1, dtype=np.uint32)
    if bits <= 8:
        pal = np.frombuffer(data, np.uint8, entry * colors, pal_at)
        pal = pal.reshape(colors, entry)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else np.arange(colors)
        if (pal == np.asarray(ramp)[:, None]).all() and colors <= 256:
            # a grey palette: Pillow reads the indices as grey levels
            rgb = np.repeat((px * np.uint8(255) if colors == 2
                             else px)[..., None], 3, axis=2)
        else:
            full = np.zeros((256, 3), np.uint8)       # past the end: black
            full[:min(colors, 256)] = pal[:256]
            rgb = full[px]
    else:
        if masks is None:
            masks = {16: (0x7C00, 0x3E0, 0x1F), 24: (0xFF0000, 0xFF00, 0xFF),
                     32: (0xFF0000, 0xFF00, 0xFF)}[bits]
        elif bits == 32 and masks == (0, 0, 0):       # Pillow: BGRA
            masks = (0xFF0000, 0xFF00, 0xFF)
        rgb = np.stack([_channel(px, m) for m in masks], axis=-1)
    return np.ascontiguousarray(rgb if top_down else rgb[::-1])


def read_bmp(path: str) -> np.ndarray:
    """A BMP (any that decode_bmp reads; write_bmp's among them) as
    [H, W, 3] float32 / 255, row 0 the top; other BMPs raise an error
    that names their format."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        rgb = decode_bmp(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return rgb.astype(np.float32) / 255.0
