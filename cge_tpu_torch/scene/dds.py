"""DDS textures without Pillow: the first surface, as Pillow 12's
DdsImageFile reads it and `convert("RGB")` converts it (the JAX package's
loader).

The 124-byte header gives the size and the pixel format, whose flags are
taken in Pillow's order, the first that is set deciding:

  RGB        uncompressed pixels of bitcount // 8 little-endian bytes, no
             row padding (the pitch is ignored); each channel's mask
             shifted down to its lowest set bit and scaled as Pillow's
             DdsRgbDecoder does, int(v / (mask >> shift) * 255) in double
             precision, a zero mask giving 0; pixels past the end of the
             file read as 0, as that decoder reads them.
  LUMINANCE  8-bit grey, or 16-bit grey + alpha where ALPHAPIXELS is set.
  PALETTE8   a 1,024-byte RGBA palette, then an index a pixel.
  FOURCC     DXT1, DXT3, DXT5, ATI1 / BC4U (BC4), ATI2 / BC5U (BC5), BC5S,
             or DX10 with its 20-byte header: DXGI BC1 to BC5 (typeless and
             unorm), BC5 snorm, BC6H UF16 and SF16, BC7 (typeless, unorm and
             sRGB, whose pixels are the unorm pixels) and R8G8B8A8
             (typeless, unorm and sRGB, raw RGBA).

Block-compressed data decodes in the native library (native/cge_bcn.cpp)
over the padded 4x4 block grid, cropped to the image's size. Mipmaps, cube
faces and array slices past the first are ignored. What Pillow refuses
raises a ValueError that names DDS and the case: another header size, a
FourCC or DXGI format outside the lists above (DXT2, DXT4, BC4S, the float
formats, ...), pixel format flags outside the four, luminance at another
depth, an empty image, and a body shorter than the first surface.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

MAGIC = b"DDS "
HEADER = 124
# DDS_PIXELFORMAT flags
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = (0x1, 0x4, 0x20, 0x40,
                                                        0x20000)
# FourCC -> (BCn kind, signed), as Pillow's DdsImageFile maps them
FOURCCS = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
           b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
           b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (BCn kind, signed); kind 0: raw R8G8B8A8
DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False),
        76: (3, False), 77: (3, False), 79: (4, False), 80: (4, False),
        82: (5, False), 83: (5, False), 84: (5, True), 95: (6, False),
        96: (6, True), 97: (7, False), 98: (7, False), 99: (7, False),
        27: (0, False), 28: (0, False), 29: (0, False)}
# BCn kind -> Pillow's mode
_BC_MODES = {1: "RGBA", 2: "RGBA", 3: "RGBA", 4: "L", 5: "RGB", 6: "RGB",
             7: "RGBA"}


def _body(data: bytes, pos: int, need: int, what: str) -> np.ndarray:
    """data[pos:pos + need] as uint8; ValueError where the file is
    shorter."""
    have = max(0, len(data) - pos)
    if have < need:
        raise ValueError(f"DDS {what} is truncated: {have} of its {need} "
                         f"bytes ({need - have} missing)")
    return np.frombuffer(data, np.uint8, need, pos)


def _masked(data: bytes, width: int, height: int, bitcount: int,
            masks) -> np.ndarray:
    """The RGB branch: [H, W, 3] uint8 from bitcount // 8-byte pixels and
    the red, green and blue masks, as DdsRgbDecoder gives them."""
    n, bc = width * height, bitcount // 8
    take = min(bc, 4)                   # the masks see the low 32 bits
    v = np.zeros(n, np.uint32)
    body = np.frombuffer(data, np.uint8, offset=4 + HEADER)
    if bc:
        k = min(n, -(-len(body) // bc))     # the pixels that start in the file
        padded = np.concatenate([body, np.zeros(3, np.uint8)])
        word = np.zeros((k, 4), np.uint8)
        word[:, :take] = np.lib.stride_tricks.as_strided(padded, (k, take),
                                                         (bc, 1))
        v[:k] = word.view("<u4")[:, 0]
    out = np.zeros((n, 3), np.uint8)
    for c, mask in enumerate(masks[:3]):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            top = mask >> shift
            val = (v & np.uint32(mask)) >> np.uint32(shift)
            if top < 1 << 16:           # each value's byte from a table
                out[:, c] = (np.arange(top + 1) / top * 255).astype(
                    np.uint8)[val]
            else:
                out[:, c] = (val / top * 255).astype(np.uint8)
    return out.reshape(height, width, 3)


def open_dds(data: bytes) -> tuple:
    """DDS bytes -> the first surface as Pillow opens it (mode, pixels,
    palette; modes.rgb): 8-bit luminance and BC4 as L, the palette image
    as P."""
    if data[:4] != MAGIC:
        raise ValueError("not a DDS file (no DDS signature)")
    size = struct.unpack_from("<I", data, 4)[0] if len(data) >= 8 else HEADER
    if size != HEADER:
        raise ValueError(f"DDS with a {size}-byte header: only {HEADER} "
                         f"exists")
    _body(data, 4, HEADER, "header")
    height, width = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    masks = struct.unpack_from("<4I", data, 92)
    if not width or not height:
        raise ValueError(f"DDS of {width}x{height} pixels: an image has at "
                         f"least one")
    native.check_pixels("DDS", width, height)
    n, pos = width * height, 4 + HEADER
    if pfflags & RGB:
        return ("RGBA" if pfflags & ALPHAPIXELS else "RGB",
                _masked(data, width, height, bitcount, masks), None)
    if pfflags & LUMINANCE:
        alpha = bool(pfflags & ALPHAPIXELS)
        if bitcount == 8 or (bitcount == 16 and alpha):
            ch = bitcount // 8
            grey = _body(data, pos, n * ch, f"{bitcount}-bit luminance")
            grey = grey[::ch].reshape(height, width)
            return ("L", grey, None) if ch == 1 else (
                "LA", modes.grey(grey), None)
        raise ValueError(f"DDS luminance at {bitcount} bits "
                         f"{'with' if alpha else 'without'} alpha: only "
                         f"8-bit L and 16-bit L with alpha exist")
    if pfflags & PALETTEINDEXED8:
        body = _body(data, pos, 1024 + n, "8-bit palette image")
        palette = body[:1024].reshape(256, 4)[:, :3]
        return "P", body[1024:].reshape(height, width), palette
    if not pfflags & FOURCC:
        raise ValueError(f"DDS with pixel format flags 0x{pfflags:x}: none "
                         f"of RGB, luminance, 8-bit palette and FourCC")
    name = fourcc.decode("latin-1")
    if fourcc == b"DX10":
        dxgi = struct.unpack("<I", _body(data, pos, 4, "DX10 header"))[0]
        if dxgi not in DXGI:
            raise ValueError(f"DDS with DXGI format {dxgi}: only BC1 to "
                             f"BC5, BC6H UF16 and SF16, BC7 and R8G8B8A8 "
                             f"are read")
        kind, signed = DXGI[dxgi]
        name, pos = f"DX10 DXGI format {dxgi}", min(len(data), pos + 20)
    elif fourcc in FOURCCS:
        kind, signed = FOURCCS[fourcc]
    else:
        raise ValueError(f"DDS with FourCC {name!r}: only DXT1, DXT3, DXT5, "
                         f"ATI1, BC4U, ATI2, BC5U, BC5S and DX10 are read")
    if kind == 0:
        rgba = _body(data, pos, n * 4, f"{name} image")
        return "RGBA", rgba.reshape(height, width, 4)[..., :3].copy(), None
    rgba = np.empty((-(-height // 4) * 4, -(-width // 4) * 4, 4), np.uint8)
    try:
        native.bcn(data[pos:], kind, signed, rgba)
    except ValueError as e:
        raise ValueError(f"DDS {name}: {e}") from None
    if kind == 4:                                     # BC4: L
        return "L", np.ascontiguousarray(rgba[:height, :width, 0]), None
    return (_BC_MODES[kind], np.ascontiguousarray(rgba[:height, :width, :3]),
            None)
