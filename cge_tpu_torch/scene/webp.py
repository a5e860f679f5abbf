"""WebP textures without Pillow: the first frame, as Pillow 12 reads it
through libwebp's animation decoder and `convert("RGB")` converts it (the
JAX package's loader).

The RIFF chunks are walked as libwebp's demuxer walks them, with its
checks: the RIFF size must fit in the file (bytes past it are ignored),
every chunk must fit in the RIFF, and the first chunk is `VP8 ` or `VP8L`
(a simple file) or `VP8X` (an extended one, flags within libwebp's valid
set). An extended still image is an optional `ALPH` chunk and a `VP8 `
bitstream, or a `VP8L` one, of exactly the canvas size; an animation
(`ANIM`, then `ANMF` frames) gives its first frame, decoded onto a
transparent black canvas at the frame's offset, which must lie within the
canvas. Pillow decodes to RGBA without premultiplying, so the alpha (the
`ALPH` plane, or VP8L's own) changes no output pixel; it is decoded all
the same, since a file whose alpha does not decode is refused.

The bitstreams decode in the native library (native/cge_webp.cpp): VP8L
lossless, VP8 lossy key frames through libwebp's fancy upsampler and its
YUV -> RGB, and ALPH. What libwebp refuses raises a ValueError that names
the format, as does a file truncated anywhere.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

# libwebp's VP8X flags: ICC, alpha, EXIF, XMP, animation
_ANIMATION, _VALID_FLAGS = 0x02, 0x3E
_MAX_CHUNK = (1 << 32) - 1 - 10
_MAX_AREA = 1 << 32


def _le24(b: bytes, pos: int) -> int:
    return b[pos] | b[pos + 1] << 8 | b[pos + 2] << 16


def _features(data: bytes, start: int, end: int, lossless: bool):
    """(width, height) of the VP8 / VP8L bitstream data[start:end], as
    libwebp's VP8GetInfo and VP8LGetInfo check it."""
    b = data[start:end]
    if lossless:
        if len(b) < 5 or b[0] != 0x2F or b[4] >> 5:
            raise ValueError("WebP VP8L bitstream without a valid header")
        bits = int.from_bytes(b[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(b) < 10 or b[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP VP8 bitstream without a key-frame start code")
    tag = b[0] | b[1] << 8 | b[2] << 16
    w, h = struct.unpack_from("<HH", b, 6)
    w, h = w & 0x3FFF, h & 0x3FFF
    if tag & 1 or (tag >> 1) & 7 > 3 or not (tag >> 4) & 1 \
            or tag >> 5 >= end - start or not w or not h:
        raise ValueError("WebP VP8 bitstream with an invalid frame header")
    return w, h


class _Frame:
    """One image: its ALPH payload (or None), its bitstream and size."""

    alpha: tuple[int, int] | None = None
    image: tuple[int, int] | None = None
    lossless = False
    width = height = 0


def _chunk(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size, padded end) of the chunk at
    pos; ValueError where it does not fit in the RIFF."""
    if end - pos < 8:
        raise ValueError("WebP file is truncated in a chunk header")
    fourcc = data[pos:pos + 4]
    size = struct.unpack_from("<I", data, pos + 4)[0]
    if size > _MAX_CHUNK or pos + 8 + size + (size & 1) > end:
        raise ValueError(f"WebP {fourcc.decode('latin-1')!r} chunk runs past "
                         f"the end of the file")
    return fourcc, pos + 8, size, pos + 8 + size + (size & 1)


def _store_frame(data: bytes, pos: int, end: int) -> tuple[_Frame, int]:
    """libwebp's StoreFrame: an optional ALPH chunk, then a VP8 or VP8L
    one, from pos; the frame and the position past it."""
    frame = _Frame()
    while pos < end:
        fourcc, start, size, nxt = _chunk(data, pos, end)
        if fourcc == b"ALPH" and frame.alpha is None and frame.image is None:
            frame.alpha = (start, size)
        elif fourcc in (b"VP8 ", b"VP8L") and frame.image is None:
            frame.lossless = fourcc == b"VP8L"
            if frame.lossless and frame.alpha is not None:
                raise ValueError("WebP VP8L image after an ALPH chunk")
            frame.image = (start, nxt - start)
            frame.width, frame.height = _features(data, start, nxt,
                                                  frame.lossless)
        else:
            break
        pos = nxt
    if frame.image is None:
        raise ValueError("WebP frame without a VP8 or VP8L bitstream")
    return frame, pos


def _decode_frame(data: bytes, frame: _Frame) -> np.ndarray:
    """The frame's pixels as [h, w, 4] uint8 RGBA."""
    w, h = frame.width, frame.height
    rgba = np.zeros((h, w, 4), np.uint8)
    start, size = frame.image
    payload = data[start:start + size]
    native.webp("vp8l" if frame.lossless else "vp8", payload, rgba)
    if frame.alpha is not None:
        a0, an = frame.alpha
        native.webp("alph", data[a0:a0 + an], rgba)
    return rgba


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> the first frame as [H, W, 3] uint8 RGB, row 0 = top."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file (no RIFF WEBP header)")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 8 or riff > _MAX_CHUNK:
        raise ValueError(f"WebP file with a RIFF size of {riff}")
    end = riff + 8
    if len(data) < end:
        raise ValueError(f"WebP file is truncated ({len(data)} of {end} "
                         f"bytes)")
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):
        frame, pos = _store_frame(data, 12, end)
        if 0 < end - pos < 8:
            raise ValueError("WebP file is truncated in a chunk header")
        native.check_pixels("WebP", frame.width, frame.height)
        return np.ascontiguousarray(_decode_frame(data, frame)[..., :3])
    if first != b"VP8X":
        raise ValueError(f"WebP file whose first chunk is {first!r}: only "
                         f"VP8, VP8L and VP8X start one")
    _, start, size, pos = _chunk(data, 12, end)
    if size < 10:
        raise ValueError(f"WebP VP8X chunk of {size} bytes")
    flags = data[start]
    cw, ch = _le24(data, start + 4) + 1, _le24(data, start + 7) + 1
    if cw * ch >= _MAX_AREA or flags & ~_VALID_FLAGS:
        raise ValueError(f"WebP VP8X header of a {cw}x{ch} canvas with "
                         f"flags {flags:#x}")
    animated = bool(flags & _ANIMATION)
    frame, offset, anim = None, (0, 0), False
    while pos < end:
        fourcc, cstart, size, nxt = _chunk(data, pos, end)
        if fourcc == b"VP8X":
            raise ValueError("WebP file with a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if animated or anim or frame is not None:
                raise ValueError("WebP image chunk outside its place")
            frame, pos = _store_frame(data, pos, end)
            if 0 < end - pos < 8:
                raise ValueError("WebP file is truncated in a chunk header")
            continue
        if fourcc == b"ANIM":
            if size + (size & 1) < 6:
                raise ValueError(f"WebP ANIM chunk of {size} bytes")
            anim = True
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("WebP ANMF frame before its ANIM chunk")
            if size + (size & 1) < 16:
                raise ValueError(f"WebP ANMF chunk of {size} bytes")
            if animated and frame is None:
                sub, sub_end = _store_frame(data, cstart + 16, end)
                if sub_end - (cstart + 16) > size + (size & 1) - 16:
                    raise ValueError("WebP ANMF frame runs past its chunk")
                frame = sub
                offset = (2 * _le24(data, cstart), 2 * _le24(data, cstart + 3))
        pos = nxt
    if frame is None:
        raise ValueError("WebP file without an image")
    x0, y0 = offset
    fmt = f"WebP {'animation' if animated else 'image'} frame"
    if animated:
        if x0 + frame.width > cw or y0 + frame.height > ch:
            raise ValueError(f"{fmt} of {frame.width}x{frame.height} at "
                             f"({x0}, {y0}) past its {cw}x{ch} canvas")
    elif (frame.width, frame.height) != (cw, ch):
        raise ValueError(f"{fmt} of {frame.width}x{frame.height} on a "
                         f"{cw}x{ch} canvas")
    native.check_pixels("WebP", cw, ch)
    canvas = np.zeros((ch, cw, 3), np.uint8)      # transparent black
    canvas[y0:y0 + frame.height, x0:x0 + frame.width] = \
        _decode_frame(data, frame)[..., :3]
    return canvas
