"""XPM textures (X11 pixmaps) without Pillow, as Pillow 12's XpmImagePlugin
reads them and `convert("RGB")` converts them (the JAX package's loader),
line by line:

  - after "/* XPM */", the first line that starts with the values string
    '"W H N K' (W, H, N colours, K characters a pixel; an empty number
    raises, as int("") does);
  - N colour lines, each stripped of trailing whitespace: its key is
    line[1:K + 1], its specs line[K + 1:-2] split at whitespace, read in
    pairs up to the first "c": "c #rrggbb" (any hexadecimal Python's int()
    reads, its low 24 bits) is a colour, "c None" leaves the key out of the
    palette; a symbolic colour, a missing "c", or one with no value,
    raises;
  - up to 256 colours give a palette image (pixel keys looked up in the
    palette's keys, its colours in order), more an RGB one (pixel keys
    looked up in the colour table);
  - then the pixel lines, a first "/* pixels */" line passed over: each
    line's text between its first and last '"' (inner quotes kept) cut
    into keys of K characters (the last one may be shorter), until the
    image's pixels are read or the file ends.

A key missing from the palette (a "None" colour's among them) raises, as
it does in Pillow, and so does a file whose lines hold too few pixels;
more are ignored. A file whose values line never comes raises
native.NotOpened, as Pillow's plugin cannot open it.
"""

from __future__ import annotations

import re

import numpy as np

from cge_tpu_torch import native

# XpmImagePlugin.xpm_head
HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
SIGNATURE = b"/* XPM */"


def accept(data: bytes) -> bool:
    return data.startswith(SIGNATURE)


def _lines(data: bytes, pos: int):
    """fp.readline() from pos on: each line with its b"\\n"."""
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        yield data[pos:end]
        pos = end


def _int(group: bytes, what: str) -> int:
    if not group:
        raise ValueError(f"XPM values line without its {what} (invalid "
                         f"literal for int())")
    return int(group)


def _palette(lines, n: int, bpp: int) -> dict:
    """The colour lines: {key: (r, g, b)}, in the order keys first come."""
    palette = {}
    for _ in range(n):
        line = next(lines, b"").rstrip()
        key, specs = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(specs), 2):
            if specs[i] != b"c":
                continue
            if i + 1 >= len(specs):
                raise native.NotOpened(f"XPM colour {key!r} has a 'c' key "
                                       f"without a value")
            rgb = specs[i + 1]
            if rgb == b"None":
                break
            if not rgb.startswith(b"#"):
                raise ValueError(f"XPM colour {key!r} is {rgb!r}, not "
                                 f"#rrggbb: cannot read this XPM file")
            try:
                v = int(rgb[1:], 16)
            except ValueError:
                raise ValueError(f"XPM colour {key!r} is {rgb!r}, not "
                                 f"hexadecimal") from None
            palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
            break
        else:
            raise ValueError(f"XPM colour line {line[:40]!r} has no 'c' key: "
                             f"cannot read this XPM file")
    return palette


def decode_xpm(data: bytes) -> np.ndarray:
    """XPM bytes -> [H, W, 3] uint8 RGB, row 0 = top."""
    if not accept(data):
        raise native.NotOpened("not an XPM file")
    lines = _lines(data, len(SIGNATURE))
    for line in lines:
        m = HEAD.match(line)
        if m:
            break
    else:
        raise native.NotOpened("broken XPM file (no values line)")
    w, h = _int(m.group(1), "width"), _int(m.group(2), "height")
    n, bpp = _int(m.group(3), "colours"), _int(m.group(4), "characters a "
                                                       "pixel")
    palette = _palette(lines, n, bpp)
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"XPM of {w}x{h} pixels")
    native.check_pixels("XPM", w, h)
    # the palette image's colours in the order of their keys (the RGB
    # image's looked up by key: the same colours)
    colours = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    index = {k: i for i, k in enumerate(palette)}
    kind = "RGB" if n > 256 else "palette"
    want, got, parts, header = w * h, 0, [], False
    for line in lines:
        if got >= want:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        row = [text[i:i + bpp] for i in range(0, len(text), bpp)]
        try:
            parts.append(np.array([index[k] for k in row], np.int64))
        except KeyError as e:
            raise ValueError(f"XPM ({kind}) pixel key {e.args[0]!r} is not "
                             f"in its colour table") from None
        got += len(row)
    if got < want:
        raise ValueError(f"XPM pixel lines end after {got} of its {want} "
                         f"pixels (not enough image data)")
    idx = np.concatenate(parts)[:want].reshape(h, w)
    return colours[idx]
