"""PNG and BMP images without Pillow (counterpart of
cge_tpu/scene/image_io.py).

`load_image` decodes PNG with zlib and struct alone, as the reference's
stb_image loads a texture (framework/src/image.cpp:22-34): forced RGB, u8 /
255 as float32, row 0 the top of the image. It reads 8-bit, non-interlaced
PNG of colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6
(RGBA) with any of the five row filters; alpha is dropped, as stb's and
Pillow's RGB conversions drop it. Other PNGs raise an error that names
their format. `png_bytes` and `write_png` write the same kinds, each row
with a chosen filter. `write_bmp` writes the CLI's 24-bit BMP byte for
byte as the JAX package does, and `read_bmp` reads it back.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines' bytes [height, stride] with each row's filter undone
    (PNG spec section 9); Sub and Up are vectorised, Average and Paeth
    run byte by byte."""
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            pad = (-stride) % bpp
            ext = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = (np.cumsum(ext.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   & 0xFF).astype(np.uint8).reshape(-1)[:stride]
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a PNG colour type")
    fmt = f"{depth}-bit {_NAMES[ctype]} PNG"
    if depth != 8:
        raise ValueError(f"{fmt}: only 8-bit PNG is supported")
    if interlace:
        raise ValueError(f"interlaced (Adam7) {fmt}: only non-interlaced "
                         f"PNG is supported")
    ch = CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    px = rows.reshape(height, width, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{fmt} without a PLTE chunk")
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if ch <= 2:                                   # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].copy()


def load_image(path: str) -> Image:
    """stb_image-style load of a PNG: forced RGB, u8 -> f32 / 255."""
    with open(path, "rb") as f:
        rgb = decode_png(f.read())
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


def read_bmp(path: str) -> np.ndarray:
    """A BMP as write_bmp writes it (24-bit, uncompressed) back as
    [H, W, 3] float32 / 255, row 0 the top; other BMPs raise an error
    that names their format."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (_, _, _, _, offset, _, w, h, _, bpp, comp, *_) = struct.unpack(
        _BMP_HEADER, data[:54])
    if bpp != 24 or comp != 0:
        raise ValueError(f"{path}: {bpp}-bit BMP with compression {comp}: "
                         f"only uncompressed 24-bit BMP is supported")
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, stride * abs(h), offset)
    rgb = rows.reshape(abs(h), stride)[:, :w * 3].reshape(abs(h), w, 3)
    rgb = rgb[:, :, ::-1]
    if h > 0:                                   # bottom-up rows
        rgb = rgb[::-1]
    return rgb.astype(np.float32) / 255.0
