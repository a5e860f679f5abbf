"""JPEG 2000 textures without Pillow: J2K codestreams and JP2 files, as
Pillow 12's Jpeg2KImagePlugin and its C decoder (Jpeg2KDecode.c over
OpenJPEG 2.5.4) read them and `convert("RGB")` converts them (the JAX
package's loader).

The codestream is decoded by the native library (native.J2k,
cge_j2k.cpp): each tile's components as OpenJPEG reconstructs them, in the
order OpenJPEG hands the tiles to Pillow. This module holds Pillow's side:

  the header  Pillow's own parse of the first bytes: a bare codestream's
              SIZ (the size XSiz - XOSiz by YSiz - YOSiz, mode L or I;16 by
              the first component's depth, LA, RGB or RGBA by the count),
              or a JP2 file's boxes to its jp2h: ihdr (L for up to 9 bits,
              its bit depth field read as the depth), colr 12 (CMYK), pclr
              (P or PA, its palette built by ImagePalette.getcolor, which
              drops repeated colours) and res; then OpenJPEG's own reading
              of the JP2 boxes (signature, ftyp, jp2h with ihdr, colr,
              bpcc, pclr, cmap, cdef; jp2c; the ihdr's size the SIZ's),
              whose first enumerated colr gives the colour space (16 sRGB,
              17 grey, 18 sYCC, 12 CMYK, 24 e-YCC; any other, an ICC
              profile or none leave it unspecified, as in a bare
              codestream: grey for one or two components, sRGB for three
              or four, but sYCC where the first component is whole and the
              second or third subsampled);
  the checks  one to four components and an unpacker for the mode, colour
              space and component count (one that reads subsampled
              components where any is subsampled);
  unpacking   each tile's samples laid out as OpenJPEG writes them for Pillow
              (each component in turn, whole, 1, 2 or 4 bytes a sample) into
              a zeroed buffer of the larger of that size and Pillow's (the
              tile's pixels times the components' sample sizes), then read
              back by Pillow's arithmetic: the tile's offset from the image
              origin on the reference grid, a component's rows w / dx samples
              long (floor), the precision shifted to 8 (or, for I;16, 16)
              bits (a left shift, or a right shift after adding half of the
              step), signed samples offset by 2^(prec - 1), everything
              wrapping to the byte; sYCC through Pillow's fixed-point YCbCr
              table (modes.ycbcr_to_rgb);
  convert     I;16 saturated at 255, P and PA through the palette (black
              past its last entry), CMYK through Pillow's cmyk2rgb
              (modes.cmyk_to_rgb), alpha dropped.

What Pillow refuses raises a ValueError that names JPEG 2000 and the case;
a file whose first bytes are JPEG 2000's but whose header Pillow's plugin
cannot open raises native.NotOpened, so the loader tries the next format,
as Image.open does.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene import modes

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's colour spaces (openjpeg.h's OPJ_COLOR_SPACE)
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

# Jpeg2KDecode.c's unpackers: (mode, colour space, components) -> (unpacker,
# whether it reads subsampled components)
_UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", False),
    ("P", SRGB, 1): ("gray_l", False),
    ("PA", SRGB, 2): ("graya_la", False),
    ("I;16", GRAY, 1): ("gray_i", False),
    ("LA", GRAY, 2): ("graya_la", False),
    ("RGB", GRAY, 1): ("gray_rgb", False),
    ("RGB", GRAY, 2): ("gray_rgb", False),
    ("RGB", SRGB, 3): ("srgb_rgb", True),
    ("RGB", SYCC, 3): ("sycc_rgb", True),
    ("RGB", SRGB, 4): ("srgb_rgb", True),
    ("RGB", SYCC, 4): ("sycc_rgb", True),
    ("RGBA", GRAY, 1): ("gray_rgb", False),
    ("RGBA", GRAY, 2): ("graya_la", False),
    ("RGBA", GRAY, 4): ("srgba_rgba", True),
    ("RGBA", SRGB, 3): ("srgb_rgb", True),
    ("RGBA", SYCC, 3): ("sycc_rgb", True),
    ("RGBA", SRGB, 4): ("srgba_rgba", True),
    ("RGBA", SYCC, 4): ("sycca_rgba", True),
    ("CMYK", CMYK, 4): ("srgba_rgba", True),
}


def accept(data: bytes) -> bool:
    """Jpeg2KImagePlugin's test: a codestream's SOC + SIZ or the JP2
    signature box."""
    return data[:4] == J2K_MAGIC or data[:12] == JP2_MAGIC


class _File:
    """The reads Pillow's plugin makes on the file: short reads at its end,
    and a seek before its start an error (OSError on a real file)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        out = self.data[self.pos:] if n < 0 else self.data[self.pos:
                                                           self.pos + n]
        self.pos += len(out)
        return out

    def seek(self, off: int) -> None:
        if self.pos + off < 0:
            raise ValueError("JPEG 2000: Pillow's reader seeks before the "
                             "file's start")
        self.pos += off


def _unpack(fmt: str, buf: bytes, at: int = 0) -> tuple:
    """struct.unpack_from, where Image.open's struct.error is the plugin's
    failure to open the file."""
    try:
        return struct.unpack_from(fmt, buf, at)
    except struct.error:
        raise native.NotOpened("JPEG 2000 header cut short") from None


def _parse_codestream(f: _File) -> tuple:
    """Jpeg2KImagePlugin._parse_codestream: ((width, height), mode) from
    the SIZ marker segment."""
    hdr = f.read(2)
    (lsiz,) = _unpack(">H", hdr)
    siz = hdr + f.read(lsiz - 2)
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = _unpack(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        (ssiz,) = _unpack(">B", siz, 38)
        mode = "I;16" if (ssiz & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        raise native.NotOpened(f"JPEG 2000 codestream of {csiz} components: "
                               f"unable to determine J2K image mode")
    return size, mode


class _Palette:
    """ImagePalette.getcolor's allocation: a colour seen before gets its
    first index; more than 256 colours raise."""

    def __init__(self, mode: str):
        self.mode, self.palette, self.colors = mode, bytearray(), {}

    def getcolor(self, color: tuple) -> None:
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("JPEG 2000 palette: cannot add non-opaque "
                                 "RGBA color to RGB palette")
            color = color[:3]
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return
        index = len(self.palette) // len(self.mode)
        if index >= 256:
            raise ValueError("JPEG 2000 palette of more than 256 distinct "
                             "colours: cannot allocate more than 256 colors")
        self.colors[color] = index
        at = index * len(self.mode)
        self.palette[at:at + len(self.mode)] = bytes(color)

    def rgb(self) -> np.ndarray:
        """The image's 256 palette entries as convert("RGB") reads them:
        these colours' first three bytes, then black."""
        n = len(self.mode)
        out = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(bytes(self.palette), np.uint8)
        count = min(len(entries) // n, 256)
        out[:count] = entries[:count * n].reshape(count, n)[:, :3]
        return out


class _Boxes:
    """Jpeg2KImagePlugin.BoxReader over a run of boxes: SyntaxError (not
    opened) where a read would pass a box's or the run's end; an OSError
    (an error) where the file ends first."""

    def __init__(self, f: _File, length: int = -1):
        self.f, self.length, self.remaining = f, length, -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.f.pos + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise native.NotOpened("JPEG 2000 header: not enough data in "
                                   "header")
        data = self.f.read(n)
        if len(data) < n:
            raise ValueError(f"JPEG 2000 header cut short: expected to read "
                             f"{n} bytes but only got {len(data)}")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def sub_boxes(self) -> _Boxes:
        size = self.remaining
        return _Boxes(_File(self.read_bytes(size)), size)

    def has_next(self) -> bool:
        return (self.f.pos + self.remaining < self.length
                if self.length >= 0 else True)

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.f.seek(self.remaining)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            (lbox,) = self.fields(">Q")
            hlen = 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise native.NotOpened("JPEG 2000 header: invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _parse_jp2_header(f: _File) -> tuple:
    """Jpeg2KImagePlugin._parse_jp2_header: ((width, height), mode,
    palette) from the boxes to the jp2h box and its sub-boxes."""
    reader = _Boxes(f)
    while True:
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub_boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = palette = None
    nc = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            elif nc in (2, 3, 4):
                mode = ("LA", "RGB", "RGBA")[nc - 2]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(header.fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub_boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise native.NotOpened("JPEG 2000 header: malformed JP2 header")
    return size, mode, palette


def _parse_comment(f: _File) -> None:
    """Jpeg2KImagePlugin._parse_comment: the marker segments after SIZ, up
    to a COM, SOT or EOC marker."""
    while True:
        marker = f.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise native.NotOpened("JPEG 2000 header cut short in a marker")
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return
        (length,) = _unpack(">H", f.read(2))
        if typ == 0x64:
            f.read(length - 2)
            return
        f.seek(length - 2)


def pillow_header(data: bytes) -> tuple:
    """Jpeg2KImageFile._open: (codec "j2k" or "jp2", (width, height), mode,
    palette or None); native.NotOpened where the plugin cannot open the
    file."""
    f = _File(data, 4)
    if data[:4] == J2K_MAGIC:
        size, mode = _parse_codestream(f)
        _parse_comment(f)
        codec, palette = "j2k", None
    elif data[:12] == JP2_MAGIC:
        f.pos = 12
        size, mode, palette = _parse_jp2_header(f)
        if f.read(12).endswith(b"jp2c" + J2K_MAGIC):
            (length,) = _unpack(">H", f.read(2))
            f.seek(length - 2)
            _parse_comment(f)
        codec = "jp2"
    else:
        raise native.NotOpened("not a JPEG 2000 file")
    if size[0] <= 0 or size[1] <= 0:
        raise native.NotOpened(f"JPEG 2000 image of {size[0]}x{size[1]} "
                               f"pixels")
    return codec, size, mode, palette


# ------------------------------------------------------------ OpenJPEG JP2

_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _box_header(data: bytes, at: int, end: int) -> tuple:
    """opj_jp2_read_boxhdr_char: (length, type, header bytes)."""
    if end - at < 8:
        raise ValueError("JPEG 2000 JP2 header: a box of less than 8 bytes")
    length, kind = struct.unpack_from(">I4s", data, at)
    hlen = 8
    if length == 1:
        if end - at < 16:
            raise ValueError("JPEG 2000 JP2 header: an XL box of less than 16 "
                             "bytes")
        high, length = struct.unpack_from(">II", data, at + 8)
        if high:
            raise ValueError("JPEG 2000 JP2 box of more than 2^32 bytes")
        hlen = 16
    if length == 0:
        raise ValueError("JPEG 2000 JP2 header: a box of undefined size")
    if length < hlen:
        raise ValueError("JPEG 2000 JP2 header: a box length is "
                         "inconsistent")
    return length, kind, hlen


class _Jp2State:
    def __init__(self):
        self.ihdr = False
        self.enumcs = 0
        self.colr = False
        self.pclr = None            # channel count of the pclr box
        self.cmap = self.cdef = False

    def image_box(self, kind: bytes, body: bytes) -> None:
        """The readers of opj_jp2_img_find_handler's boxes."""
        n = len(body)
        if kind == b"ihdr":
            if self.ihdr:
                return                    # a second ihdr is ignored
            if n != 14:
                raise ValueError("JPEG 2000 JP2 ihdr box: bad size")
            h, w, nc = struct.unpack_from(">IIH", body)
            if not 1 <= nc <= 16384 or not h or not w:
                raise ValueError(f"JPEG 2000 JP2 ihdr box: {w}x{h} pixels, "
                                 f"{nc} components")
            self.ihdr = True
            self.w, self.h = w, h
            self.nc, self.bpc = nc, body[10]
        elif kind == b"colr":
            if n < 3:
                raise ValueError("JPEG 2000 JP2 colr box: bad size")
            if self.colr:
                return                    # only the first counts
            meth = body[0]
            if meth == 1:
                if n < 7:
                    raise ValueError("JPEG 2000 JP2 colr box: bad size")
                (self.enumcs,) = struct.unpack_from(">I", body, 3)
                if self.enumcs == 14 and n not in (7, 35):
                    raise ValueError("JPEG 2000 JP2 colr box of CIELab: bad "
                                     "size")
                self.colr = True
            elif meth == 2:
                self.colr = True
        elif kind == b"bpcc":
            if not self.ihdr or n != self.nc:
                raise ValueError("JPEG 2000 JP2 bpcc box: bad size")
        elif kind == b"pclr":
            if self.pclr is not None or n < 3:
                raise ValueError("JPEG 2000 JP2 pclr box: a second one, or "
                                 "too short")
            entries, channels = struct.unpack_from(">HB", body)
            if not 1 <= entries <= 1024 or not channels:
                raise ValueError(f"JPEG 2000 JP2 pclr box of {entries} "
                                 f"entries and {channels} columns")
            if n < 3 + channels:
                raise ValueError("JPEG 2000 JP2 pclr box: too short")
            need = 3 + channels + entries * sum(
                ((b & 0x7F) + 1 + 7) >> 3 for b in body[3:3 + channels])
            if n < need:
                raise ValueError("JPEG 2000 JP2 pclr box: its entries are "
                                 "cut short")
            self.pclr = channels
        elif kind == b"cmap":
            if self.pclr is None:
                raise ValueError("JPEG 2000 JP2 cmap box before its pclr box")
            if self.cmap:
                raise ValueError("JPEG 2000 JP2: a second cmap box")
            if n < 4 * self.pclr:
                raise ValueError("JPEG 2000 JP2 cmap box: too short")
            self.cmap = True
        elif kind == b"cdef":
            if self.cdef:
                raise ValueError("JPEG 2000 JP2: a second cdef box")
            if n < 2:
                raise ValueError("JPEG 2000 JP2 cdef box: too short")
            (count,) = struct.unpack_from(">H", body)
            if not count or n < 2 + 6 * count:
                raise ValueError(f"JPEG 2000 JP2 cdef box of {count} "
                                 f"channels: too short")
            self.cdef = True


def openjpeg_jp2(data: bytes) -> tuple:
    """opj_jp2_read_header: (offset of the codestream, colour space, the
    ihdr's (width, height)) of a JP2 file, as OpenJPEG reads its boxes."""
    st = _Jp2State()
    at, n = 0, len(data)
    signature = ftyp = jp2h = False
    while n - at >= 8:
        length, kind = struct.unpack_from(">I4s", data, at)
        hlen = 8
        if length == 0:
            length = n - at
        elif length == 1:
            if n - at < 16:
                break
            high, length = struct.unpack_from(">II", data, at + 8)
            if high:
                raise ValueError("JPEG 2000 JP2 box of more than 2^32 bytes")
            hlen = 16
        if kind == b"jp2c":
            if not jp2h:
                raise ValueError("JPEG 2000 JP2: a codestream box before the "
                                 "jp2h box")
            return (at + hlen, _ENUMCS.get(st.enumcs, UNSPECIFIED),
                    (st.w, st.h))
        if length < hlen:
            raise ValueError(f"JPEG 2000 JP2: an invalid size of box "
                             f"{kind!r}")
        body_at, end = at + hlen, at + length
        known = kind in (b"jP  ", b"ftyp", b"jp2h")
        if known or kind in _IMG_BOXES:
            if not known and not jp2h:
                at = end                  # ignored before jp2h
                if at > n:
                    raise ValueError("JPEG 2000 JP2: a box runs past the "
                                     "file's end")
                continue
            if end > n:
                raise ValueError(f"JPEG 2000 JP2: box {kind!r} runs past the "
                                 f"file's end")
            body = data[body_at:end]
            if kind == b"jP  ":
                if signature or ftyp or jp2h:
                    raise ValueError("JPEG 2000 JP2: the signature box is not "
                                     "the first box")
                if len(body) != 4 or body != b"\x0d\x0a\x87\x0a":
                    raise ValueError("JPEG 2000 JP2: a bad signature box")
                signature = True
            elif kind == b"ftyp":
                if not signature or ftyp or jp2h:
                    raise ValueError("JPEG 2000 JP2: the ftyp box is not the "
                                     "second box")
                if len(body) < 8 or (len(body) - 8) % 4:
                    raise ValueError("JPEG 2000 JP2: a bad ftyp box size")
                ftyp = True
            elif kind == b"jp2h":
                if not ftyp:
                    raise ValueError("JPEG 2000 JP2: the jp2h box before the "
                                     "ftyp box")
                sub = 0
                has_ihdr = False
                while sub < len(body):
                    blen, bkind, bhlen = _box_header(body, sub, len(body))
                    if blen > len(body) - sub:
                        raise ValueError("JPEG 2000 JP2 jp2h box: a box "
                                         "length is inconsistent")
                    if bkind in _IMG_BOXES:
                        st.image_box(bkind, body[sub + bhlen:sub + blen])
                    has_ihdr |= bkind == b"ihdr"
                    sub += blen
                if not has_ihdr:
                    raise ValueError("JPEG 2000 JP2 jp2h box without an ihdr "
                                     "box")
                jp2h = True
            else:
                st.image_box(kind, body)
        else:
            if not signature:
                raise ValueError("JPEG 2000 JP2: the first box is not the "
                                 "signature box")
            if not ftyp:
                raise ValueError("JPEG 2000 JP2: the second box is not the "
                                 "ftyp box")
            if end > n:
                raise ValueError(f"JPEG 2000 JP2: box {kind!r} runs past the "
                                 f"file's end")
        at = end
    if not jp2h:
        raise ValueError("JPEG 2000 JP2 without a jp2h box")
    raise ValueError("JPEG 2000 JP2 without a codestream box")


# ------------------------------------------------------------ unpacking

def _words(buf: np.ndarray, at: np.ndarray, size: int) -> np.ndarray:
    """The little-endian words of size bytes at byte offsets `at` of buf."""
    out = np.zeros(at.shape, np.uint64)
    for k in range(size):
        out |= buf[at + k].astype(np.uint64) << np.uint64(8 * k)
    return out


def _shifted(words: np.ndarray, prec: int, sgnd: bool, bits: int
             ) -> np.ndarray:
    """j2ku_shift(offset + word, shift) as Pillow computes it, in unsigned
    32-bit arithmetic, to `bits` bits (8 or 16) of the result."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (words + np.uint64(offset)) & np.uint64(0xFFFFFFFF)
    v = v >> np.uint64(-shift) if shift < 0 else v << np.uint64(shift)
    return (v & np.uint64((1 << bits) - 1)).astype(
        np.uint8 if bits == 8 else np.uint16)


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _tile_bytes(tile, comps) -> np.ndarray:
    """opj_tcd_update_tile_data: each component's samples in turn, 1, 2 or
    4 little-endian bytes a sample, wrapped."""
    parts = []
    for (prec, _, _, _), s in zip(comps, tile[2]):
        c = _csiz(prec)
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[c]
        parts.append((s.astype(np.int64) & ((1 << (8 * c)) - 1)).astype(dt)
                     .view(np.uint8).ravel())
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def _unpack_tile(kind: str, buf: np.ndarray, comps, w: int, h: int,
                 out: np.ndarray, x0: int, y0: int) -> None:
    """One of Jpeg2KDecode.c's unpackers: the tile's w x h pixels from
    Pillow's buffer into out (Pillow's storage) at (x0, y0)."""
    ys, xs = np.meshgrid(np.arange(h, dtype=np.int64),
                         np.arange(w, dtype=np.int64), indexing="ij")
    bits = 16 if kind == "gray_i" else 8
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        prec, sgnd = comps[0][:2]
        c = _csiz(prec)
        v = _shifted(_words(buf, c * (ys * w + xs), c), prec, sgnd, bits)
        if kind == "gray_rgb":
            out[y0:y0 + h, x0:x0 + w, :3] = v[..., None]
            out[y0:y0 + h, x0:x0 + w, 3] = 255
        else:
            out[y0:y0 + h, x0:x0 + w] = v
        return
    if kind == "graya_la":
        (p0, s0), (p1, s1) = comps[0][:2], comps[1][:2]
        c0, c1 = _csiz(p0), _csiz(p1)
        v = _shifted(_words(buf, c0 * (ys * w + xs), c0), p0, s0, 8)
        a = _shifted(_words(buf, c0 * w * h + c1 * (ys * w + xs), c1), p1,
                     s1, 8)
        out[y0:y0 + h, x0:x0 + w, :3] = v[..., None]
        out[y0:y0 + h, x0:x0 + w, 3] = a
        return
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    base = 0
    region = out[y0:y0 + h, x0:x0 + w]
    for i in range(n):
        prec, sgnd, dx, dy = comps[i]
        c = _csiz(prec)
        cw = w // dx
        region[..., i] = _shifted(_words(buf, base + c * (
            (ys // dy) * cw + xs // dx), c), prec, sgnd, 8)
        base += c * cw * (h // dy)
    if n == 3:
        region[..., 3] = 255
    if kind.startswith("sycc"):
        region[..., :3] = modes.ycbcr_to_rgb(
            region[..., 0], region[..., 1], region[..., 2])


def decode_jpeg2000(data: bytes, opened: tuple | None = None) -> tuple:
    """A J2K codestream or JP2 file -> (mode, pixels in Pillow's storage,
    palette or None), as Pillow's plugin and decoder leave the image:
    [H, W] uint8 for L and P, [H, W] uint16 for I;16, [H, W, 4] uint8 for
    LA, PA, RGB, RGBA and CMYK. opened: pillow_header's result, where the
    caller has it."""
    codec, size, mode, palette = opened or pillow_header(data)
    native.check_pixels(f"JPEG 2000 ({mode})", *size)
    if codec == "jp2":
        start, space, ihdr = openjpeg_jp2(data)
    else:
        start, space, ihdr = 0, UNSPECIFIED, None
    with native.J2k(data, start) as stream:
        comps = stream.comps
        n = len(comps)
        siz = (stream.x1 - stream.x0, stream.y1 - stream.y0)
        if ihdr is not None and ihdr != siz:
            raise ValueError(f"JPEG 2000 JP2 whose ihdr box's {ihdr[0]}x"
                             f"{ihdr[1]} is not the SIZ marker's {siz[0]}x"
                             f"{siz[1]}")
        if not 1 <= n <= 4:
            raise ValueError(f"JPEG 2000 image of {n} components: Pillow "
                             f"decodes 1 to 4")
        subsampled = any((dx, dy) != (1, 1) for _, _, dx, dy in comps)
        if space == UNSPECIFIED:
            space = GRAY if n <= 2 else SYCC if comps[0][2:] == (1, 1) and any(
                (dx, dy) != (1, 1) for _, _, dx, dy in comps[1:3]) else SRGB
        found = _UNPACKERS.get((mode, space, n))
        if found is None or (subsampled and not found[1]):
            names = {GRAY: "grey", SRGB: "sRGB", SYCC: "sYCC", EYCC: "e-YCC",
                     CMYK: "CMYK"}
            raise ValueError(f"JPEG 2000 {mode} image of {n} "
                             f"{names[space]} components"
                             f"{' (subsampled)' if subsampled else ''}: "
                             f"Pillow has no unpacker for it")
        kind = found[0]
        w, h = size
        if mode in ("L", "P"):
            out = np.zeros((h, w), np.uint8)
        elif mode == "I;16":
            out = np.zeros((h, w), np.uint16)
        else:
            out = np.zeros((h, w, 4), np.uint8)
        width = sum(_csiz(prec) for prec, _, _, _ in comps)
        for tile in stream.tiles():
            tx0, ty0, tx1, ty1 = tile[1]
            if (tx0 >= tx1 or ty0 >= ty1 or tx0 < stream.x0
                    or ty0 < stream.y0 or tx1 - stream.x0 > w
                    or ty1 - stream.y0 > h):
                raise ValueError(f"JPEG 2000 tile {tile[0]} ({tx0}, {ty0}) - "
                                 f"({tx1}, {ty1}) lies outside the "
                                 f"{w}x{h} image")
            tw, th = tx1 - tx0, ty1 - ty0
            raw = _tile_bytes(tile, comps)
            buf = np.zeros(max(len(raw), tw * th * width), np.uint8)
            buf[:len(raw)] = raw
            _unpack_tile(kind, buf, comps, tw, th, out, tx0 - stream.x0,
                         ty0 - stream.y0)
    return mode, out, palette


def to_rgb(mode: str, px: np.ndarray, palette) -> np.ndarray:
    """Pillow's convert("RGB") of an image decode_jpeg2000 gives."""
    if mode == "L":
        return np.repeat(px[..., None], 3, axis=2)
    if mode == "I;16":
        return np.repeat(np.minimum(px, 255).astype(np.uint8)[..., None], 3,
                         axis=2)
    if mode in ("P", "PA"):
        return palette.rgb()[px if mode == "P" else px[..., 0]]
    if mode == "CMYK":
        return modes.cmyk_to_rgb(*(px[..., i] for i in range(4)))
    if mode == "LA":
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_jp2(data: bytes) -> np.ndarray:
    """J2K or JP2 bytes -> [H, W, 3] uint8 RGB, row 0 = top, as Pillow's
    `convert("RGB")` gives them."""
    if not accept(data):
        raise ValueError("not a JPEG 2000 file (no J2K or JP2 signature)")
    return to_rgb(*decode_jpeg2000(data))
