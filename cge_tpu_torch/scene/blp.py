"""BLP textures (Blizzard's BLP1 and BLP2) without Pillow, as Pillow 12's
BlpImagePlugin reads them and `convert("RGB")` converts them (the JAX
package's loader).

The header (28 bytes in BLP1, 20 in BLP2: compression, alpha, encodings,
size) is followed by 16 mipmap offsets and 16 lengths; only the first
mipmap is read:

  BLP1, compression 0  a JPEG: the shared header that follows the tables
                       (its length, then its bytes), then the mipmap's
                       bytes at its offset, decoded by the port's JPEG
                       decoder (scene/jpeg.py, native/cge_jpeg.cpp); the
                       RGB bytes it gives are read as BGR, the first width
                       x height pixels of them in order. A CMYK stream
                       keeps Pillow's inverted reading of Adobe CMYK: the
                       plugin sets the decoder's colour space to CMYK,
                       which its stream already has, and keeps the
                       inverting raw mode.
  BLP1, compression 1  encodings 4 and 5: indices into the 256-entry BGRA
                       palette after the tables; the indices follow the
                       palette (the offset is not read).
  BLP2, compression 1  encoding 1: palette indices at the mipmap's offset;
                       encoding 2: DXT1 (alpha encoding 0), DXT3 (1) or
                       DXT5 (7) blocks, through the plugin's own decoders,
                       not Pillow's C BCn decoder: 5-6-5 endpoints shifted
                       without replicating their top bits, integer thirds
                       and halves, DXT3 and DXT5 always in four-colour
                       mode. The block rows come out at the width rounded
                       up to 4, 3 bytes a pixel (DXT1 without alpha) or 4,
                       and are read as width x height pixels of the image's
                       mode (RGB, or RGBA with the alpha flag), so a width
                       that is no multiple of 4, or DXT3 / DXT5 without the
                       alpha flag, shears the pixels as in Pillow.

What Pillow refuses raises a ValueError that names BLP: another
compression (BLP2's JPEG too) or encoding (BLP1's other than 4 and 5,
BLP2's 3, raw BGRA), another alpha encoding, a palette, table or mipmap cut
short, and too few pixels. A header too short to read, or an empty image,
is not a BLP image to Pillow, which goes on to the next format
(native.NotOpened).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import jpeg

ALPHA_ENCODINGS = {0: "DXT1", 1: "DXT3", 7: "DXT5"}


def accept(data: bytes) -> bool:
    return data[:4] in (b"BLP1", b"BLP2")


def _read(data: bytes, pos: int, n: int, what: str) -> bytes:
    """data[pos:pos + n]; ValueError where the file is shorter (Pillow's
    _safe_read)."""
    if n <= 0:
        return b""
    if pos + n > len(data):
        raise ValueError(f"BLP {what} is truncated (Truncated File Read)")
    return data[pos:pos + n]


def _as_pixels(flat: np.ndarray, w: int, h: int, bands: int,
               fmt: str) -> np.ndarray:
    """The first w x h pixels of `bands` bytes of flat, as Pillow's
    set_as_raw reads them -> [h, w, 3] RGB."""
    if len(flat) < w * h * bands:
        raise ValueError(f"{fmt}: {len(flat)} bytes for {w}x{h} pixels of "
                         f"{bands} bytes (not enough image data)")
    return np.ascontiguousarray(
        flat[:w * h * bands].reshape(h, w, bands)[..., :3])


def _rgb565(c: np.ndarray) -> np.ndarray:
    """BlpImagePlugin.unpack_565: [..., 3] int (no bit replication)."""
    c = c.astype(np.int32)
    return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2,
                     (c & 31) << 3], axis=-1)


def _dxt(body: bytes, kind: str, bw: int, bh: int,
         alpha: bool) -> np.ndarray:
    """The plugin's decode_dxt1 / 3 / 5 over bh rows of bw blocks -> the
    bytes it gives, [4 bh, 4 bw, 3 or 4] uint8."""
    size = 8 if kind == "DXT1" else 16
    blk = np.frombuffer(body, np.uint8).reshape(bh, bw, size)
    colour = blk[..., size - 8:]
    c0 = colour[..., 0].astype(np.int32) | colour[..., 1].astype(np.int32) << 8
    c1 = colour[..., 2].astype(np.int32) | colour[..., 3].astype(np.int32) << 8
    code = colour[..., 4:8].copy().view("<u4")[..., 0]
    p = np.arange(16, dtype=np.uint32)
    sel = ((code[..., None] >> (2 * p)) & 3).astype(np.int32)  # [bh, bw, 16]
    e0, e1 = _rgb565(c0), _rgb565(c1)                          # [bh, bw, 3]
    four = (c0 > c1) if kind == "DXT1" else np.ones(c0.shape, bool)
    four = four[..., None]
    pal = np.stack([e0, e1,
                    np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2),
                    np.where(four, (2 * e1 + e0) // 3, 0)], axis=2)
    rgb = np.take_along_axis(pal, sel[..., None], axis=2)      # [bh,bw,16,3]
    if kind == "DXT1":
        a = np.where((sel == 3) & ~four, 0, 255)
    elif kind == "DXT3":
        nib = blk[..., p // 2].astype(np.int32)
        a = np.where(p % 2 == 1, nib >> 4, nib & 15) * 17
    else:
        a0 = blk[..., 0].astype(np.int32)[..., None]
        a1 = blk[..., 1].astype(np.int32)[..., None]
        v = np.zeros(blk.shape[:2], np.uint64)
        for k in range(6):
            v |= blk[..., 2 + k].astype(np.uint64) << np.uint64(8 * k)
        ac = ((v[..., None] >> (3 * p).astype(np.uint64)) & np.uint64(7)
              ).astype(np.int32)
        a = np.where(a0 > a1, ((8 - ac) * a0 + (ac - 1) * a1) // 7,
                     np.where(ac == 6, 0, np.where(
                         ac == 7, 255, ((6 - ac) * a0 + (ac - 1) * a1) // 5)))
        a = np.where(ac == 0, a0, np.where(ac == 1, a1, a))
    px = np.concatenate([rgb, a[..., None]], axis=-1)
    if kind == "DXT1" and not alpha:
        px = px[..., :3]
    ch = px.shape[-1]
    px = px.reshape(bh, bw, 4, 4, ch).transpose(0, 2, 1, 3, 4)
    return px.reshape(4 * bh, 4 * bw, ch).astype(np.uint8)


def decode_blp(data: bytes) -> np.ndarray:
    """BLP1 or BLP2 bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not accept(data):
        raise ValueError("not a BLP file (no BLP1 or BLP2 signature)")
    blp1 = data[:4] == b"BLP1"
    if len(data) < (24 if blp1 else 20):     # the fields Pillow's _open reads
        raise native.NotOpened(f"BLP header of {len(data)} bytes")
    need = 28 if blp1 else 20
    compression = struct.unpack_from("<i", data, 4)[0]
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        alpha_encoding = None
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = struct.unpack_from("<II", data, 12)
    fmt = (f"{data[:4].decode()} of compression {compression} and encoding "
           f"{encoding}")
    if not w or not h:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    native.check_pixels(fmt, w, h)
    bands = 4 if alpha else 3
    tables = _read(data, need, 128, "mipmap table")
    offset0 = struct.unpack_from("<I", tables)[0]
    length0 = struct.unpack_from("<I", tables, 64)[0]
    pos = need + 128
    if blp1 and compression == 0:
        hsize = struct.unpack("<I", _read(data, pos, 4, "JPEG header size"))[0]
        header = _read(data, pos + 4, hsize, "JPEG header")
        pos += 4 + hsize
        _read(data, pos, offset0 - pos, "JPEG mipmap's offset")
        pos = max(pos, offset0)
        stream = header + _read(data, pos, length0, "JPEG mipmap")
        if stream[:3] != b"\xff\xd8\xff":
            raise ValueError(f"{fmt}: its JPEG stream does not start with "
                             f"a JPEG signature (not a JPEG file)")
        try:
            rgb = jpeg.decode_jpeg(stream)
        except ValueError as e:
            raise ValueError(f"{fmt}: its JPEG: {e}") from None
        # the RGB bytes read as BGR
        return _as_pixels(rgb.reshape(-1), w, h, 3, fmt)[..., ::-1].copy()
    if compression != 1:
        raise ValueError(f"{fmt}: Pillow reads compression 1 (and BLP1's "
                         f"0, JPEG) only")
    if blp1 and encoding not in (4, 5):
        raise ValueError(f"{fmt}: Pillow reads BLP1 encodings 4 and 5 only")
    palette = np.frombuffer(_read(data, pos, 1024, "palette"),
                            np.uint8).reshape(256, 4)[:, 2::-1]
    if blp1:
        idx = np.frombuffer(_read(data, pos + 1024, length0, "mipmap"),
                            np.uint8)
        return _as_pixels(palette[idx].reshape(-1), w, h, 3, fmt)
    if encoding == 1:
        idx = np.frombuffer(_read(data, offset0, length0, "mipmap"),
                            np.uint8)
        return _as_pixels(palette[idx].reshape(-1), w, h, 3, fmt)
    if encoding != 2:
        raise ValueError(f"{fmt}: Pillow reads BLP2 encodings 1 "
                         f"(uncompressed) and 2 (DXT) only (Unknown BLP "
                         f"encoding)")
    kind = ALPHA_ENCODINGS.get(alpha_encoding)
    if kind is None:
        raise ValueError(f"{fmt} with alpha encoding {alpha_encoding}: "
                         f"Pillow reads 0 (DXT1), 1 (DXT3) and 7 (DXT5) "
                         f"only")
    bw, bh = (w + 3) // 4, (h + 3) // 4
    body = _read(data, offset0, bw * bh * (8 if kind == "DXT1" else 16),
                 f"{kind} mipmap")
    px = _dxt(body, kind, bw, bh, alpha)
    return _as_pixels(px.reshape(-1), w, h, bands, f"{fmt} ({kind})")
