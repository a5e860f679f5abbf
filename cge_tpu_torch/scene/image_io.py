"""Textures without Pillow (counterpart of cge_tpu/scene/image_io.py):
PNG, BMP, JPEG, GIF, TGA, PNM, PSD, TIFF, WebP and DDS.

`load_image` decodes a texture as the JAX package's loader does, whose
`convert("RGB")` through Pillow is the reference: forced RGB, u8 / 255 as
float32, row 0 the top of the image (the reference's stb_image,
framework/src/image.cpp:22-34, which opens the first seven formats and
HDR and PIC besides). The format comes from the file's signature, never
its name, in Pillow's order (`format_of`):

  PNG   every bit depth of every colour type (1, 2, 4 and 8-bit grey and
        palette, 16-bit grey, grey + alpha, RGB and RGBA), plain or Adam7
        interlaced, any row filter; inflated with zlib, the filters undone
        in the native library, the samples unpacked in numpy. Pillow's
        conversions: 1-, 2- and 4-bit grey scaled by 255, 85 and 17;
        16-bit grey saturated at 255; the other 16-bit samples keep their
        high byte; alpha and tRNS dropped; a palette index past the PLTE
        chunk's end is black.
  BMP   1-, 4- and 8-bit palette (also RLE8 and RLE4), 16-bit 5-5-5 and
        bitfields, 24-bit, 32-bit plain and bitfields; header sizes 12
        (OS/2 core), 40, 52, 56, 64, 108 and 124; bottom-up or top-down
        rows (`decode_bmp`).
  JPEG  baseline and progressive Huffman, 8-bit, grey or three components
        at 4:4:4, 4:2:2 or 4:2:0, as libjpeg-turbo decodes it
        (scene/jpeg.py and the native library's cge_image.cpp).
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
  TGA   colour-mapped, true-colour and grey, raw or run-length, in each
        orientation (scene/tga.py); TGA has no signature, so it is tried
        last, by Pillow's test of its header.

Any other format (QOI, ICO, Radiance HDR, OpenEXR, PAM, PFM, ...) raises a
ValueError that names it,
as does a truncated or corrupt file. `png_bytes` and `write_png` write
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
from cge_tpu_torch.scene import dds, gif, jpeg, pnm, psd, tga, tiff, webp

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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB, row 0 = top, as Pillow's
    `convert("RGB")` gives them."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
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
    if ctype not in CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a PNG colour type")
    fmt = f"{depth}-bit {_NAMES[ctype]} PNG"
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{fmt}: the PNG spec allows {_NAMES[ctype]} at "
                         f"{_DEPTHS[ctype]} bits only")
    if interlace not in (0, 1):
        raise ValueError(f"{fmt} with interlace method {interlace}: only "
                         f"none and Adam7 exist")
    native.check_pixels(fmt, width, height)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{fmt}: the image data does not inflate ({e})") \
            from None
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


def format_of(data: bytes) -> str:
    """The image format that the file's first bytes name, tried in
    Pillow's order: "PNG", "BMP", "JPEG", "GIF", "PNM", "PSD", "TIFF"
    (Pillow's six prefixes, BigTIFF's among them), "DDS", "WebP" or "TGA"
    for the formats that decode here, else the name of another known
    format, or "unknown". TGA, which has no signature, comes last, by
    Pillow's test of its header."""
    head = data[:16]
    for sig, name in ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                      (b"\xff\xd8\xff", "JPEG"), (SIGNATURE, "PNG"),
                      (b"8BPS", "PSD"),
                      *((p, "TIFF") for p in tiff.PREFIXES),
                      (b"DDS ", "DDS"), (b"qoif", "QOI"),
                      (b"\x00\x00\x01\x00", "ICO"),
                      (b"#?RADIANCE", "Radiance HDR"),
                      (b"\x76\x2f\x31\x01", "OpenEXR")):
        if head.startswith(sig):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:1] == b"P" and head[1:2] and head[1:2] in b"123456":
        return "PNM"
    if head[:2] in (b"P7", b"Pf", b"PF"):
        return {b"P7": "PAM"}.get(head[:2], "PFM")
    if tga.header_ok(data):
        return "TGA"
    return "unknown"


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> [H, W, 3] uint8 RGB, row 0 = top, the decoder
    chosen by the signature. ValueError naming the format for any other,
    and for a file its decoder cannot read."""
    decoders = {"PNG": decode_png, "BMP": decode_bmp,
                "JPEG": jpeg.decode_jpeg, "GIF": gif.decode_gif,
                "PNM": pnm.decode_pnm, "PSD": psd.decode_psd,
                "TGA": tga.decode_tga, "TIFF": tiff.decode_tiff,
                "WebP": webp.decode_webp, "DDS": dds.decode_dds}
    fmt = format_of(data)
    if fmt not in decoders:
        what = ("an image of unknown format (its first bytes are "
                f"{data[:8]!r})" if fmt == "unknown" else f"a {fmt} file")
        raise ValueError(f"{what}, not a PNG, BMP, JPEG, GIF, PNM, PSD, "
                         f"TGA, TIFF, WebP or DDS file: {fmt} images are not "
                         f"supported")
    try:
        return decoders[fmt](data)
    except ValueError as e:
        if fmt in str(e):                 # the message names the format
            raise
        raise ValueError(f"{fmt}: {e}") from None


def load_image(path: str) -> Image:
    """stb_image-style load of a PNG, BMP, JPEG, GIF, PNM, PSD, TGA, TIFF,
    WebP or DDS file:
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
    bytes, realigned to an even offset in the file."""
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
    idx = np.zeros(total, np.uint8)
    got = np.frombuffer(bytes(out[:total]), np.uint8)
    idx[:len(got)] = got
    return idx


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
    offset, hsize = struct.unpack_from("<II", data, 10)
    info = data[18:14 + hsize]
    masks = None
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
            else:
                masks = struct.unpack_from("<III", data, 14 + hsize)
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
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:            # as Pillow reads it
        offset += 4 * colors
    if comp in (1, 2):
        idx = _rle_indices(data, offset, w, h, comp == 2)
        px = idx.reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = np.frombuffer(data, np.uint8, stride * h, offset)
        rows = rows.reshape(h, stride)
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
        pal = np.frombuffer(data, np.uint8, entry * colors, 14 + hsize)
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
