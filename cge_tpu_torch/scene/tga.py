"""TGA textures without Pillow, as Pillow 12's TgaImagePlugin reads them
and `convert("RGB")` converts them (the JAX package's loader).

Image types 1, 2 and 3 (colour-mapped, true colour, grey) and their
run-length forms 9, 10 and 11: true colour at 16 (5-5-5, each channel
scaled by 255 // 31), 24 and 32 bits; grey at 1, 8 and 16 (grey + alpha)
bits, through the colour map where the file has one, as Pillow applies
it; 8-bit indices into a 16- or 24-bit colour map that starts at its first
entry index (entries before it, and indices past its end, are black). The
image ID is skipped; rows run bottom-up unless bit 5 of the descriptor is
set, and bit 4 flips the image left to right; alpha is dropped. The
run-length packets decode in the native library (native.tga_rle): a
literal packet flows on into the next row, a run packet that crosses a
row's end is an error, as in Pillow.

What Pillow refuses raises a ValueError that names it: a 32-bit or 15-bit
colour map, a true-colour image with a colour map, a colour-mapped image
without one, run-length 1-bit grey, and the depths Pillow has no reader
for (8-bit true colour, 24-bit grey, ...). TGA has no signature:
`header_ok` is Pillow's test of the header, and the loader tries it last.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

# id length, colour-map type, image type, map start, map length, map
# depth, x origin, y origin, width, height, depth, descriptor
HEADER = "<BBBHHBHHHHBB"
# (image type & 7, depth) -> what Pillow reads
_KINDS = {(1, 8): "palette", (3, 1): "1-bit grey", (3, 8): "grey",
          (3, 16): "grey + alpha", (2, 16): "5-5-5", (2, 24): "BGR",
          (2, 32): "BGRA"}


def header_ok(data: bytes) -> bool:
    """Pillow's TgaImageFile._open test: colour-map type 0 or 1, a width
    and height above 0, depth 1, 8, 16, 24 or 32, image type 1, 2, 3, 9,
    10 or 11, and a 16-, 24- or 32-bit colour map where there is one."""
    if len(data) < 18:
        return False
    _, cmtype, itype, _, _, cmdepth, _, _, w, h, depth, _ = \
        struct.unpack_from(HEADER, data)
    return (cmtype in (0, 1) and w > 0 and h > 0
            and depth in (1, 8, 16, 24, 32)
            and itype in (1, 2, 3, 9, 10, 11)
            and (not cmtype or cmdepth in (16, 24, 32)))


def _rgb555(v: np.ndarray) -> np.ndarray:
    """16-bit little-endian pixels -> [..., 3] RGB, as Pillow's
    BGRA;15Z unpacker gives them."""
    v = v.astype(np.uint32)
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)],
                    axis=-1).astype(np.uint8)


def _colour_map(data: bytes, pos: int, start: int, length: int,
                depth: int) -> np.ndarray:
    """The colour map as [256, 3] RGB: black before `start` and past its
    end."""
    entry = depth // 8
    raw = np.frombuffer(data, np.uint8, length * entry, pos)
    if depth == 16:
        rgb = _rgb555(raw.view("<u2"))
    else:
        rgb = raw.reshape(length, 3)[:, ::-1]
    full = np.zeros((256, 3), np.uint8)
    full[start:start + length] = rgb
    return full


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not header_ok(data):
        raise ValueError("not a TGA file (its header fails Pillow's test)")
    (id_len, cmtype, itype, start, length, cmdepth, _, _, w, h, depth,
     flags) = struct.unpack_from(HEADER, data)
    base, rle = itype & 7, bool(itype & 8)
    fmt = f"{depth}-bit TGA of image type {itype}"
    kind = _KINDS.get((base, depth))
    if kind is None:
        raise ValueError(f"{fmt}: Pillow has no reader for it")
    if base == 1 and not cmtype:
        raise ValueError(f"{fmt}: colour-mapped without a colour map")
    if cmtype and base == 2:
        raise ValueError(f"{fmt}: a true-colour image with a colour map, "
                         f"which Pillow cannot read")
    if cmtype and depth == 1:
        raise ValueError(f"{fmt}: 1-bit grey with a colour map, which "
                         f"Pillow cannot read")
    if cmtype and cmdepth == 32:
        raise ValueError(f"{fmt} with a 32-bit colour map, which Pillow "
                         f"cannot read")
    if rle and depth == 1:
        raise ValueError(f"{fmt}: run-length 1-bit grey, which Pillow "
                         f"cannot read")
    if cmtype and start + length > 256:
        raise ValueError(f"{fmt}: a colour map of {start + length} "
                         f"entries, past Pillow's 256")
    native.check_pixels(fmt, w, h)
    pos = 18 + id_len
    pal = None
    if cmtype:
        end = pos + length * (cmdepth // 8)
        if end > len(data):
            raise ValueError(f"{fmt}: the colour map is truncated")
        pal = _colour_map(data, pos, start, length, cmdepth)
        pos = end
    row_bytes = (w * depth + 7) // 8
    if rle:
        rows = native.tga_rle(data, pos, depth // 8, row_bytes, h)
    else:
        if pos + h * row_bytes > len(data):
            raise ValueError(f"{fmt}: the image data is truncated")
        rows = np.frombuffer(data, np.uint8, h * row_bytes, pos).reshape(
            h, row_bytes)
    if kind == "1-bit grey":
        rgb = np.repeat(np.unpackbits(rows, axis=1)[:, :w, None] * np.uint8(
            255), 3, axis=2)
    else:
        px = rows.reshape(h, w, depth // 8)
        if kind in ("palette", "grey", "grey + alpha"):
            idx = px[..., 0]
            rgb = pal[idx] if pal is not None else np.repeat(
                idx[..., None], 3, axis=2)
        elif kind == "5-5-5":
            rgb = _rgb555(px.reshape(h, -1).view("<u2"))
        else:                                         # BGR, BGRA
            rgb = px[..., 2::-1]
    if not flags & 0x20:                              # bottom-up rows
        rgb = rgb[::-1]
    if flags & 0x10:                                  # right to left
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)
