"""PNM textures without Pillow, as Pillow 12's PpmImagePlugin reads them and
`convert("RGB")` converts them (the JAX package's loader): PBM, PGM and
PPM (P1 to P6) and the plugin's other modes, grey PFM ("Pf"), "P0CMYK" and
Pillow's own test formats "PyP", "PyRGBA" and "PyCMYK".

The header's tokens are read as Pillow reads them: any whitespace between
them, a '#' comment running to the next CR or LF anywhere (even inside a
token), at most 10 characters a token, and the image data starting just
past the one whitespace character that ends the last token (the magic
number is up to 6 characters, ended by whitespace or its sixth). P1 to P3
are plain text (comments allowed in the data too; P1's digits need no
whitespace between them), the others binary.

  P1 / P4   bitmaps: 1 is black, 0 white.
  P2 / P5   grey. A maxval up to 255 is rescaled to 255 (round(v / maxval
            x 255), ties to even); above 255 the image is Pillow's 32-bit
            "I" scaled to 65,535, which convert("RGB") saturates at 255
            (P5 at maxval 65,535: the sample itself, saturated).
  P3 / P6   RGB, rescaled to 255 at any maxval (16-bit samples too).
  P0CMYK, PyCMYK   CMYK samples, rescaled to 255 as P6's are, through
            Pillow's CMYK -> RGB (scene/modes.py's copy of cmyk2rgb).
  PyRGBA    RGBA samples so rescaled, the alpha dropped.
  PyP       palette indices so rescaled, in an image with no palette:
            convert("RGB") gives black.
  Pf        grey PFM: a scale token in place of the maxval (finite, not 0;
            its sign gives the byte order, negative little-endian), 32-bit
            floats, the rows bottom-up; convert("RGB") goes through "L" as
            Pillow's f2l does: at most 0 -> 0, at least 255 -> 255, else
            truncated. A NaN sample, which f2l casts as C leaves undefined,
            raises.

Binary samples past maxval saturate at 255; plain ones raise, as do
negative ones and tokens that Python's int() does not read, samples
missing at the end of the file, a maxval outside 1 to 65,535, a scale
Python's float() does not read, 0 or not finite: each ValueError names the
format. A magic number Pillow's table has not (its test takes "P" and one
of 0-6, f, y) raises native.NotOpened, as Pillow's plugin cannot open it;
colour PFM ("PF") and PAM ("P7") are no PNM to Pillow (image_io names
them).
"""

from __future__ import annotations

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

WHITESPACE = b" \t\n\x0b\x0c\r"
# magic number -> Pillow's mode (PpmImagePlugin.MODES)
MAGIC = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
# the bands of each mode
BANDS = {"1": 1, "L": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
# Pillow's plain decoder reads the data in blocks of this many bytes
# (ImageFile.SAFEBLOCK)
_BLOCK = 1 << 20


def _magic(data: bytes) -> tuple[bytes, int]:
    """Pillow's _read_magic: up to 6 bytes, ended by whitespace (which it
    consumes)."""
    pos = 0
    while pos < min(len(data), 6):
        c = data[pos:pos + 1]
        pos += 1
        if c in WHITESPACE:
            return data[:pos - 1], pos
    return data[:pos], pos


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """Pillow's _read_token: the next header token and the position past
    the whitespace that ended it."""
    token = bytearray()
    n = len(data)
    while len(token) <= 10 and pos < n:
        c = data[pos]
        pos += 1
        if c in WHITESPACE:
            if token:
                break
        elif c == 0x23:                            # '#': to CR or LF
            ends = [i for i in (data.find(b"\n", pos), data.find(b"\r", pos))
                    if i >= 0]
            pos = min(ends) + 1 if ends else n
        else:
            token.append(c)
    if not token:
        raise ValueError("PNM header ends early")
    if len(token) > 10:
        raise ValueError(f"PNM header token {bytes(token[:11])!r} is too "
                         f"long")
    return bytes(token), pos


def _header_int(data: bytes, pos: int, what: str) -> tuple[int, int]:
    token, pos = _token(data, pos)
    try:
        return int(token), pos
    except ValueError:
        raise ValueError(f"PNM {what} {token!r} is not a number") from None


def _plain_chars(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The plain data with its comments ('#' to the next CR or LF, both
    removed) taken out: its bytes and each one's offset in `body`."""
    keep = np.ones(len(body), bool)
    pos = body.find(b"#")
    while pos >= 0:
        ends = [i for i in (body.find(b"\n", pos), body.find(b"\r", pos))
                if i >= 0]
        end = min(ends) + 1 if ends else len(body)
        keep[pos:end] = False
        pos = body.find(b"#", end)
    offsets = np.flatnonzero(keep)
    return np.frombuffer(body, np.uint8)[offsets], offsets


def _plain_bits(body: bytes, count: int, fmt: str) -> np.ndarray:
    """P1's first `count` digits as 0 / 1. Pillow checks every character
    of each block it reads, and reads until it has `count` digits."""
    chars, offsets = _plain_chars(body)
    solid = ~np.isin(chars, np.frombuffer(WHITESPACE, np.uint8))
    chars, offsets = chars[solid], offsets[solid]
    if len(chars) >= count and count:
        last_block = offsets[count - 1] // _BLOCK
        checked = chars[offsets < (last_block + 1) * _BLOCK]
    else:
        checked = chars
    bad = (checked != 0x30) & (checked != 0x31)
    if bad.any():
        raise ValueError(f"{fmt} data holds {bytes(checked[bad][:1])!r}, "
                         f"not 0 or 1")
    if len(chars) < count:
        raise ValueError(f"{fmt} data is truncated: {len(chars)} of "
                         f"{count} samples")
    return chars[:count] - 0x30


def _plain_numbers(body: bytes, count: int, maxval: int,
                   fmt: str) -> np.ndarray:
    """The first `count` whitespace-separated samples of P2 / P3 data as
    int64, each read as Python's int() reads it (a sign, digits, single
    underscores between digits), at most 10 characters, from 0 to
    maxval."""
    chars, _ = _plain_chars(body)
    solid = ~np.isin(chars, np.frombuffer(WHITESPACE, np.uint8))
    prev = np.concatenate([[False], solid[:-1]])
    after = np.concatenate([solid[1:], [False]])
    starts = np.flatnonzero(solid & ~prev)
    ends = np.flatnonzero(solid & ~after) + 1
    if len(starts) < count:
        raise ValueError(f"{fmt} data is truncated: {len(starts)} of "
                         f"{count} samples")
    if count == 0:
        return np.zeros(0, np.int64)
    starts, ends = starts[:count], ends[:count]
    if (ends - starts > 10).any():
        raise ValueError(f"{fmt} data holds a sample of more than 10 "
                         f"characters")
    c = chars[:ends[-1]].astype(np.int64)
    digit = (c >= 0x30) & (c <= 0x39)
    first = np.zeros(len(c), bool)
    first[starts] = True
    sign = first & ((c == 0x2B) | (c == 0x2D))
    inner = np.zeros(len(c), bool)                 # between two digits
    inner[1:-1] = digit[:-2] & digit[2:] & ~first[1:-1]
    under = (c == 0x5F) & inner
    ok = ~solid[:len(c)] | digit | sign | under
    # a token needs a digit after its sign
    digits_in = np.add.reduceat(digit, starts)
    if not ok.all() or (digits_in == 0).any():
        raise ValueError(f"{fmt} data holds a sample that is not a decimal "
                         f"number")
    at = np.flatnonzero(digit)
    token = np.searchsorted(starts, at, side="right") - 1
    below = np.cumsum(digit)                       # digits up to here
    weight = 10.0 ** (below[ends[token] - 1] - below[at])
    values = np.bincount(token, weights=(c[at] - 0x30) * weight,
                         minlength=count).astype(np.int64)
    negative = (c[starts] == 0x2D) & (values > 0)
    if negative.any():
        raise ValueError(f"{fmt} data holds a negative sample")
    if (values > maxval).any():
        raise ValueError(f"{fmt} sample {int(values.max())} is past its "
                         f"maxval {maxval}")
    return values


def _rescale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """Pillow's min(top, round(v / maxval x top)), ties to even."""
    return np.minimum(np.round(v.astype(np.float64) / maxval * top), top)


def accept(data: bytes) -> bool:
    """PpmImagePlugin's test of the first bytes: "P" and one of 0-6, f, y."""
    return data[:1] == b"P" and len(data) > 1 and data[1] in b"0123456fy"


def _pfm(data: bytes, pos: int, w: int, h: int, fmt: str) -> np.ndarray:
    """Pf: the scale token, then h rows of w 32-bit floats, bottom-up;
    convert("RGB") through f2l."""
    token, pos = _token(data, pos)
    try:
        scale = float(token)
    except ValueError:
        raise ValueError(f"{fmt} scale {token!r} is not a number") from None
    if scale == 0.0 or not np.isfinite(scale):
        raise ValueError(f"{fmt} scale {token!r}: scale must be finite and "
                         f"non-zero")
    body = data[pos:]
    if len(body) < 4 * w * h:
        raise ValueError(f"{fmt} data is truncated")
    v = np.frombuffer(body, "<f4" if scale < 0 else ">f4", w * h)
    return modes.grey(modes.f_to_u8(v, fmt).reshape(h, w)[::-1])


def mode_of(data: bytes) -> str:
    """The mode Pillow opens the PNM file in: its magic number's, I for
    grey past a maxval of 255; "" where the header does not read."""
    magic, pos = _magic(data)
    mode = MAGIC.get(magic, "")
    if mode == "L":
        try:
            for what in ("width", "height", "maxval"):
                maxval, pos = _header_int(data, pos, what)
        except ValueError:
            return ""
        return "I" if maxval > 255 else "L"
    return mode


def decode_pnm(data: bytes) -> np.ndarray:
    """PNM bytes of any magic number Pillow's table has -> [H, W, 3] uint8
    RGB, row 0 = top."""
    magic, pos = _magic(data)
    if magic not in MAGIC:
        raise native.NotOpened(f"not a PPM file (magic number {magic!r} is "
                               f"not one of Pillow's)")
    fmt, mode = f"{magic.decode()} PNM", MAGIC[magic]
    w, pos = _header_int(data, pos, "width")
    h, pos = _header_int(data, pos, "height")
    if w <= 0 or h <= 0:                # ImageFile: "not identified"
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    native.check_pixels(fmt, w, h)
    bands = BANDS[mode]
    count = w * h * bands
    body = data[pos:]
    if mode == "F":
        return _pfm(data, pos, w, h, fmt)
    if mode == "1":
        if magic == b"P1":
            px = _plain_bits(body, w * h, fmt).reshape(h, w)
        else:
            stride = (w + 7) // 8
            if len(body) < stride * h:
                raise ValueError(f"{fmt} data is truncated")
            rows = np.frombuffer(body, np.uint8, stride * h).reshape(h,
                                                                     stride)
            px = np.unpackbits(rows, axis=1)[:, :w]
        grey = (1 - px).astype(np.uint8) * np.uint8(255)
        return np.repeat(grey[..., None], 3, axis=2)
    maxval, pos = _header_int(data, pos, "maxval")
    if not 0 < maxval < 65536:
        raise ValueError(f"{fmt} maxval {maxval}: it must be 1 to 65535")
    body = data[pos:]
    # Pillow's "I" mode: grey past 8 bits, scaled to 65535, then saturated
    top = 65535 if (mode == "L" and maxval > 255) else 255
    if magic in (b"P2", b"P3"):
        v = _rescale(_plain_numbers(body, count, maxval, fmt), maxval, top)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < count * size:
            raise ValueError(f"{fmt} data is truncated")
        raw = np.frombuffer(body, np.uint8 if size == 1 else ">u2", count)
        if maxval == 255 or (maxval == 65535 and mode == "L"):
            v = raw                                   # Pillow's raw reads
        else:
            v = _rescale(raw, maxval, top)
    px = np.minimum(v, 255).astype(np.uint8).reshape(h, w, bands)
    if mode == "CMYK":
        return modes.cmyk_to_rgb(*(px[..., k] for k in range(4)))
    if mode == "P":                           # no palette: black
        return np.zeros((h, w, 3), np.uint8)
    if bands == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
