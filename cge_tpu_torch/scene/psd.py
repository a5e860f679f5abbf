"""PSD textures without Pillow: the merged image after the layer section,
as Pillow 12's PsdImagePlugin reads it and `convert("RGB")` converts it
(the JAX package's loader).

The header, the colour-mode data, the image resources and the layer and
mask section are walked as Pillow walks them; the image data is raw (0)
or PackBits (1), one plane a channel, and PackBits rows decode in the
native library (native.packbits), each channel from the offset its row
byte counts give, a packet cut at its row's end as Pillow cuts it. The
colour modes are those of Pillow's MODES, at 8 bits (bitmap at 1):

  bitmap        1-bit rows, a set bit white (Pillow's "1");
  grey, multichannel, duotone   the first channel as grey;
  indexed       through the 768-byte colour-mode table (R, G and B
                planes); black without one;
  RGB           three channels, a fourth (RGBA) and any more dropped;
  CMYK          stored inverted, through Pillow's CMYK -> RGB
                (255 - k - c (255 - k) / 255, rounded as Pillow does);
  LAB           three channels (L, then a and b offset by 128, as
                Photoshop stores them and Pillow reads them) through
                LittleCMS's Lab -> sRGB transform (lcms.py).

What Pillow refuses raises a ValueError that names the format: 16- and
32-bit channels, too few channels for the mode, compression 2 and 3 (ZIP),
a truncated file.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import lcms, modes

SIGNATURE = b"8BPS"
# colour mode -> its name
NAMES = {0: "bitmap", 1: "grey", 2: "indexed", 3: "RGB", 4: "CMYK",
         7: "multichannel", 8: "duotone", 9: "LAB"}
# (colour mode, depth) -> (Pillow's mode, the channels it reads)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _Reader:
    """Pillow's reads of the file: `read` returns what is there (short at
    the end), the numbers raise where bytes are missing."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def number(self, size: int) -> int:
        b = self.read(size)
        if len(b) < size:
            raise ValueError("PSD file is truncated")
        return int.from_bytes(b, "big")


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> the merged image as [H, W, 3] uint8 RGB, row 0 = top."""
    if len(data) < 26 or not data.startswith(SIGNATURE):
        raise ValueError("not a PSD file (no 8BPS signature)")
    version, channels, h, w, depth, cmode = struct.unpack_from(
        ">H6xHIIHH", data, 4)
    if version != 1:
        raise ValueError(f"PSD of version {version} (PSB): only version 1 "
                         f"is supported")
    fmt = f"{depth}-bit {NAMES.get(cmode, f'colour mode {cmode}')} PSD"
    if (cmode, depth) not in MODES:
        raise ValueError(f"{fmt}: Pillow reads PSD at 8 bits a channel "
                         f"(bitmap at 1) only")
    mode, used = MODES[(cmode, depth)]
    if used > channels:
        raise ValueError(f"{fmt} of {channels} channels: not enough "
                         f"channels")
    if mode == "RGB" and channels == 4:
        used = 4                                      # RGBA
    if w == 0 or h == 0:
        raise ValueError(f"{fmt} of {w}x{h} pixels")
    native.check_pixels(fmt, w, h)
    r = _Reader(data, 26)
    colour_data = r.read(r.number(4))
    palette = None
    if mode == "P" and len(colour_data) == 768:
        palette = np.frombuffer(colour_data, np.uint8).reshape(3, 256).T
    end = r.number(4)
    end += r.pos
    while r.pos < end:                                # image resources
        r.read(4)
        r.number(2)
        name = r.read(r.number(1))
        if not len(name) & 1:
            r.read(1)
        if len(r.read(r.number(4))) & 1:
            r.read(1)
    size = r.number(4)                                # layers and masks
    if size:
        end = r.pos + size
        r.number(4)
        r.pos = end
    compression = r.number(2)
    row_bytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    if compression == 0:
        offset = r.pos
        for _ in range(used):
            if offset + h * row_bytes > len(data):
                raise ValueError(f"{fmt}: the image data is truncated")
            planes.append(np.frombuffer(data, np.uint8, h * row_bytes,
                                        offset).reshape(h, row_bytes))
            offset += w * h
    elif compression == 1:
        counts = r.read(used * h * 2)
        if len(counts) < used * h * 2:
            raise ValueError(f"{fmt}: the PackBits row counts are truncated")
        counts = np.frombuffer(counts, ">u2").reshape(used, h)
        offset = r.pos
        for c in range(used):
            try:
                planes.append(native.packbits(data, offset, row_bytes, h))
            except ValueError as e:
                raise ValueError(f"{fmt}: {e}") from None
            offset += int(counts[c].sum())
    else:
        raise ValueError(f"{fmt} with compression {compression} (ZIP): only "
                         f"raw and PackBits are supported, as in Pillow")
    if mode == "1":
        grey = np.unpackbits(planes[0], axis=1)[:, :w] * np.uint8(255)
        return np.repeat(grey[..., None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if mode == "P":
        if palette is None:
            return np.zeros((h, w, 3), np.uint8)      # Pillow: black
        return palette[planes[0]]
    if mode == "CMYK":
        return modes.cmyk_to_rgb(*(255 - p for p in planes))
    if mode == "LAB":
        return lcms.lab_to_rgb(np.stack(planes, axis=-1))
    return np.ascontiguousarray(np.stack(planes[:3], axis=-1))
