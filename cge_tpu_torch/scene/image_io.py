"""Textures without Pillow (counterpart of cge_tpu/scene/image_io.py):
PNG, BMP, JPEG, GIF, TGA, PNM, PSD, TIFF, WebP, DDS, JPEG 2000, the
formats of model and game asset sets: SGI, PCX and DCX, QOI, ICO and CUR,
ICNS, BLP, FTEX and Sun raster, the X11 icons XBM and XPM, the legacy
formats GIMP brush, FLI / FLC, Windows Paint, Kodak PhotoCD, PIXAR and XV
thumbnail, and the science formats FITS, McIdas, SPIDER, IM, IM Tools and
IPTC/NAA.

`load_image` decodes a texture as the JAX package's loader does, whose
`convert("RGB")` through Pillow is the reference: forced RGB, u8 / 255 as
float32, row 0 the top of the image (the reference's stb_image,
framework/src/image.cpp:22-34, which opens the first seven formats and
HDR and PIC besides). The format comes from the file's first bytes, never
its name, tried in the order of Pillow's plugins (`format_of`); where a
format's test takes a file whose header its plugin cannot open
(native.NotOpened), the next format is tried, as Image.open does
(`open_image`, which gives the image as Pillow opens it: its mode, and
for 1, L, P and I;16 its band before any palette or conversion, which
`modes.rgb` converts for `decode_image`). IM, IM Tools, IPTC and SPIDER
have no test of the first bytes: their header checks run on every file
that reaches them, in their place in that order. What escapes Image.open
(an exception other than Pillow's SyntaxError, IndexError, TypeError and
struct.error) raises a ValueError here, as it ends the JAX loader's load.
The formats:

  PNG   every bit depth of every colour type (1, 2, 4 and 8-bit grey and
        palette, 16-bit grey, grey + alpha, RGB and RGBA), plain or Adam7
        interlaced, any row filter; inflated with zlib, the filters undone
        in the native library, the samples unpacked in numpy. Pillow's
        conversions: 1-, 2- and 4-bit grey scaled by 255, 85 and 17;
        16-bit grey saturated at 255; the other 16-bit samples keep their
        high byte; alpha and tRNS dropped; a palette index past the PLTE
        chunk's end, or no PLTE, is black. The chunks are walked as
        Pillow's PngImageFile walks them (_Png): before the first image
        data their CRCs, type names and handlers' checks (IHDR, PLTE in
        a palette image only, tRNS, gAMA, cHRM, sRGB, pHYs, iCCP's and
        zTXt's compression methods, iTXt, text sizes, acTL, fcTL's
        sequence and bounds, fdAT); the image data from the data chunks
        that follow one another (into an fcTL's frame where one comes
        first, the rest 0); after it the handlers of the chunks that
        follow, whose errors raise. A zlib stream cut after the last
        scanline decodes.
  BMP   1-, 4- and 8-bit palette (also RLE8 and RLE4), 16-bit 5-5-5 and
        bitfields, 24-bit, 32-bit plain and bitfields; header sizes 12
        (OS/2 core), 40, 52, 56, 64, 108 and 124; bottom-up or top-down
        rows (`decode_bmp`); a bare device-independent bitmap (DIB) too
        (`decode_dib`, which ICO and CUR entries share).
  JPEG  every kind Pillow opens, as libjpeg-turbo decodes it: Huffman or
        arithmetic, sequential, progressive (smoothed where scans leave
        coefficients unrefined) or lossless, 8-bit, grey, YCbCr, RGB,
        CMYK or YCCK at every whole sampling (scene/jpeg.py and the
        native library's cge_jpeg.cpp).
  GIF   the first frame, every colour-table case, interlaced or not, at
        its offset on the logical screen (scene/gif.py).
  PSD   the merged image, raw or PackBits, in bitmap, grey, indexed, RGB
        (A), CMYK, multichannel, duotone and LAB (scene/psd.py; LAB
        through LittleCMS's Lab -> sRGB transform, scene/lcms.py).
  PNM   P1 to P6, plain and binary, at any maxval; grey PFM ("Pf"),
        P0CMYK and Pillow's PyP, PyRGBA and PyCMYK (scene/pnm.py).
  XBM   X11 bitmaps, the header from the first 512 bytes (scene/xbm.py).
  XPM   X11 pixmaps of "c #rrggbb" colours, palette or RGB
        (scene/xpm.py).
  TIFF  the first IFD, II or MM, classic or BigTIFF, strips or tiles,
        either planar configuration, raw, LZW, Deflate, PackBits, LZMA or
        ZSTD with predictors 2 and 3, CCITT RLE, Group 3 and Group 4,
        ThunderScan, JPEG (YCbCr in planes too) and old-style JPEG
        (scene/ojpeg.py: a stream in the strips, a JPEGInterchangeFormat
        header or tables in tags; grey or YCbCr), in every mode of
        Pillow's table that convert("RGB") takes, YCbCr through libtiff's
        RGBA path and CIE L*a*b* through LittleCMS (scene/tiff.py,
        scene/lcms.py); SGILog and WebP in TIFF raise, as Pillow refuses
        them (it has no mode for LogLuv, and its libtiff has no WebP).
  WebP  the first frame: lossless VP8L, lossy VP8 with or without ALPH,
        still or animated, as libwebp decodes it (scene/webp.py).
  DDS   the first surface: uncompressed RGB masks, luminance, 8-bit
        palette, DX10 R8G8B8A8, and BC1 to BC5, BC5 signed, BC6H (UF16
        and SF16) and BC7 blocks, as Pillow's DdsImagePlugin and BCn
        decoder give them (scene/dds.py).
  JPEG 2000  J2K codestreams and JP2 files as OpenJPEG 2.5.4 under Pillow
        decodes them: 5/3 and 9/7, layers, every progression order and POC,
        tiles and tile-parts, precincts, every code-block style, ROI,
        PPT / PPM, subsampled components, 1 to 16 bits, palettes, CMYK and
        sYCC, Part 2 MCT, MCC, MCO and CBD markers as far as OpenJPEG
        reads them (scene/jpeg2000.py, the codestream in the native
        library's cge_j2k.cpp); HTJ2K codestreams raise (they wait for
        ITU-T T.814's tables), and so does what OpenJPEG refuses (a custom
        multiple component transform, a Part 2 wavelet kernel).
  TGA   colour-mapped, true-colour and grey, raw or run-length, in each
        orientation (scene/tga.py); TGA has no signature, so it is tried
        by Pillow's test of its header, in its place in Pillow's order.
  SGI   raw or run-length, grey, RGB and RGBA at 8 or 16 bits
        (scene/sgi.py).
  PCX   1 bit in 1, 2 or 4 planes, 8-bit grey or palette, RGB in 3
        planes; DCX's first page (scene/pcx.py).
  QOI   RGB and RGBA (scene/qoi.py).
  ICO   the entry Pillow picks, a PNG or a bitmap; CUR's (scene/ico.py).
  ICNS  the largest icon: a PNG or JPEG 2000 entry, or run-length colour
        (scene/icns.py).
  BLP   BLP1 JPEG and palettes, BLP2 palettes and DXT1 / DXT3 / DXT5
        through the plugin's own decoders (scene/blp.py).
  FTEX  DXT1 and raw RGB (scene/ftex.py).
  Sun   raster at 1, 4, 8, 24 and 32 bits, with colour maps, raw or
        run-length (scene/sun.py).
  GBR   GIMP brushes, versions 1 and 2, grey or RGBA (scene/gbr.py).
  FLI   FLI and FLC animations' first frame: SS2, LC, BLACK, BRUN and COPY
        chunks under a COLOR_256 or COLOR_64 palette (scene/fli.py).
  MSP   Windows Paint 1.x (raw) and 2.x (run-length rows) (scene/msp.py).
  PCD   Kodak PhotoCD's 768x512 base image, PhotoYCC through Pillow's
        tables, in each orientation (scene/pcd.py).
  PIXAR raster images of 14 channels at depth 2, RGB (scene/pixar.py).
  XV thumbnail  RGB332 thumbnails (scene/xvthumb.py).
  FITS  8-, 16- and 32-bit and float images, read little-endian and from
        the bottom as Pillow reads them, and GZIP_1 tables (scene/fits.py).
  McIdas  areas of 1-, 2- and 4-byte elements (scene/mcidas.py).
  SPIDER  float images of either byte order, a stack's first image
        (scene/spider.py).
  IM    IFUNC Image Memory in every raw layout of Pillow's table, palettes,
        2- to 31-bit samples and the bare type LAB (scene/im.py).
  IMT   IM Tools grey images (scene/imt.py).
  IPTC  IPTC/NAA streams, raw or holding a file of any format read here,
        grey or one band of RGB or CMYK, the band any image of one band as
        Image.merge reads it (scene/iptc.py).
The byte-serial parts of SGI, PCX, QOI, Sun raster, ICNS, XBM, FLI, MSP and
IM's bit-packed samples run in the native library's cge_raster.cpp;
Pillow's conversions of its modes to RGB are shared in scene/modes.py.

Any other format (AVIF, EPS, Radiance HDR, OpenEXR, PAM, colour PFM, ...)
raises a ValueError that names it, as does a truncated or corrupt file.
`png_bytes` and `write_png` write
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
from cge_tpu_torch.scene import (blp, dds, fits, fli, ftex, gbr, gif, icns,
                                 ico, im, imt, iptc, jpeg, jpeg2000, mcidas,
                                 modes,
                                 msp, pcd, pcx, pixar, pnm, psd, qoi, sgi,
                                 spider, sun, tga, tiff, webp, xbm, xpm,
                                 xvthumb)

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


# Pillow's PngImagePlugin._MODES: (bit depth, colour type) -> mode
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L",
              (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P",
              (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA",
              (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
# the bytes of a chunk type Pillow's is_cid takes (regular expression \w)
_CHUNK_TYPE = frozenset(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                        b"0123456789_")
# the chunk types PngStream has a handler for
_PNG_HANDLED = frozenset((b"IHDR", b"IDAT", b"IEND", b"PLTE", b"tRNS",
                          b"gAMA", b"cHRM", b"sRGB", b"pHYs", b"tEXt",
                          b"zTXt", b"iTXt", b"eXIf", b"acTL", b"fcTL",
                          b"fdAT", b"iCCP"))
# the data lengths below which a handler raises "Truncated ... chunk"
_PNG_SHORT = {b"IHDR": 13, b"sRGB": 1, b"pHYs": 9, b"acTL": 8, b"fcTL": 26}
# PngImagePlugin.MAX_TEXT_CHUNK and MAX_TEXT_MEMORY
_TEXT_CHUNK = 1 << 20
_TEXT_MEMORY = 64 << 20


class _Png:
    """Pillow's PngStream over the chunks: its handlers' reads and checks,
    in _open (the chunks before the first image data, each CRC checked) and
    in load_end (the chunks after it, no CRC checked). A handler raises
    native.NotOpened where Pillow's raises SyntaxError, IndexError or
    struct.error, ValueError where it raises ValueError or OSError."""

    def __init__(self, data: bytes):
        self.data = data
        self.size = (0, 0)
        self.key = None                    # (depth, colour type) of the mode
        self.interlace = False
        self.palette = None
        self.n_frames = None
        self.seq = None
        self.bbox = None
        self.default_image = False
        self.text = 0
        self.loaded = False                # the handlers of load_end
        self.ihdr = None                   # the last IHDR's depth, type and
                                           # interlace method, for messages

    def header(self, pos: int) -> tuple[bytes, int]:
        """ChunkStream.read: the type and length of the chunk at pos."""
        s = self.data[pos:pos + 8]
        if len(s) < 4:
            raise native.NotOpened("PNG chunk header cut short")
        cid = s[4:]
        if len(cid) < 4 or not all(c in _CHUNK_TYPE for c in cid):
            raise native.NotOpened(f"broken PNG file (chunk {cid!r})")
        return cid, struct.unpack_from(">I", s)[0]

    def body(self, cid: bytes, pos: int, length: int) -> bytes:
        """ImageFile._safe_read of a chunk's data."""
        s = self.data[pos:pos + length]
        if len(s) < length:
            raise ValueError(f"PNG {cid.decode()} chunk is truncated")
        return s

    def _text(self, n: int) -> None:
        self.text += n
        if self.text > _TEXT_MEMORY:
            raise ValueError("PNG text chunks hold more than Pillow's "
                             "MAX_TEXT_MEMORY")

    @staticmethod
    def _inflate_text(cid: bytes, s: bytes):
        """_safe_zlib_decompress: None where zlib fails."""
        d = zlib.decompressobj()
        try:
            out = d.decompress(s, _TEXT_CHUNK)
        except zlib.error:
            return None
        if d.unconsumed_tail:
            raise ValueError(f"PNG {cid.decode()} chunk inflates past "
                             f"Pillow's MAX_TEXT_CHUNK")
        return out

    def call(self, cid: bytes, pos: int, length: int) -> bool:
        """The handler of the chunk whose data start at pos: True where it
        is image data or the end (Pillow's EOFError)."""
        if cid == b"IEND":
            return True
        if cid == b"fdAT":
            if length < 4:
                raise ValueError("APNG contains truncated fdAT chunk")
            seq = struct.unpack(">I", self.body(cid, pos, 4))[0]
            if self.seq != seq - 1:
                raise native.NotOpened("APNG contains frame sequence errors "
                                       "(fdAT)")
            self.seq = seq
        if cid in (b"IDAT", b"fdAT"):
            if self.bbox is None and self.n_frames is not None:
                self.default_image = True
            return True
        if cid not in _PNG_HANDLED:
            return False
        s = self.body(cid, pos, length)
        if length < _PNG_SHORT.get(cid, 0):
            raise ValueError(f"Truncated PNG {cid.decode()} chunk")
        mode = _PNG_MODES.get(self.key)
        if cid == b"IHDR":
            self.size = struct.unpack_from(">II", s)
            self.ihdr = (s[8], s[9], s[12])
            if (s[8], s[9]) in _PNG_MODES:
                self.key = (s[8], s[9])
            self.interlace = self.interlace or bool(s[12])
            if s[11]:
                raise native.NotOpened("PNG of an unknown filter category")
        elif cid == b"PLTE":
            if mode == "P" and not self.loaded:   # load_end's is not used
                self.palette = s
        elif cid == b"tRNS":
            want = {"1": 2, "L": 2, "I;16": 2, "RGB": 6}.get(mode, 0)
            if len(s) < want:
                raise native.NotOpened(f"PNG tRNS chunk of {len(s)} bytes in "
                                       f"a {mode} image")
        elif cid == b"gAMA":
            if len(s) < 4:
                raise native.NotOpened("PNG gAMA chunk of fewer than 4 bytes")
        elif cid == b"cHRM":
            if len(s) % 4:
                raise native.NotOpened("PNG cHRM chunk of no whole number of "
                                       "4-byte values")
        elif cid == b"iCCP":
            i = s.find(b"\0")
            if i + 1 >= len(s):
                raise native.NotOpened("PNG iCCP chunk cut before its "
                                       "compression method")
            if s[i + 1]:
                raise native.NotOpened(f"Unknown compression method "
                                       f"{s[i + 1]} in PNG iCCP chunk")
            self._inflate_text(cid, s[i + 2:])
        elif cid in (b"tEXt", b"zTXt"):
            k, _, v = s.partition(b"\0")
            if cid == b"zTXt":
                if v and v[0]:
                    raise native.NotOpened(f"Unknown compression method "
                                           f"{v[0]} in PNG zTXt chunk")
                v = self._inflate_text(cid, v[1:]) or b""
            if k:
                self._text(len(v))
        elif cid == b"iTXt":
            self._itxt(s)
        elif cid == b"acTL":
            if self.n_frames is not None:
                self.n_frames = None
            else:
                n = struct.unpack_from(">I", s)[0]
                if 0 < n <= 0x80000000:
                    self.n_frames = n
        elif cid == b"fcTL":
            seq, w, h, x, y = struct.unpack_from(">5I", s)
            if (self.seq is None and seq != 0) or (
                    self.seq is not None and self.seq != seq - 1):
                raise native.NotOpened("APNG contains frame sequence errors "
                                       "(fcTL)")
            self.seq = seq
            if x + w > self.size[0] or y + h > self.size[1]:
                raise native.NotOpened(f"APNG contains invalid frames (a "
                                       f"{w}x{h} frame at {x}, {y} in "
                                       f"{self.size[0]}x{self.size[1]})")
            self.bbox = (x, y, x + w, y + h)
        return False

    def what(self) -> str:
        """The last IHDR's format for messages, as "16-bit palette PNG",
        whether Pillow has a mode for it or not."""
        if self.ihdr is None:
            return "PNG"
        depth, ctype, interlace = self.ihdr
        if ctype not in _NAMES:
            return f"PNG colour type {ctype}"
        return f"{depth}-bit {_NAMES[ctype]} PNG" + (
            f" with interlace method {interlace}" if interlace > 1 else "")

    def _itxt(self, s: bytes) -> None:
        """chunk_iTXt: what it cannot read it passes over; only a text that
        inflates past MAX_TEXT_CHUNK raises."""
        _, sep, r = s.partition(b"\0")
        if not sep or len(r) < 2:
            return
        cf, cm, parts = r[0], r[1], r[2:].split(b"\0", 2)
        if len(parts) < 3:
            return
        v = parts[2]
        if cf:
            if cm:
                return
            v = self._inflate_text(b"iTXt", v)
            if v is None:
                return
        try:
            parts[0].decode("utf-8")
            parts[1].decode("utf-8")
            n = len(v.decode("utf-8"))
        except UnicodeError:
            return
        self._text(n)

    def open(self) -> tuple[bytes, int, int]:
        """PngImageFile._open: the chunks up to the first image data (an
        IDAT, or an fdAT after its sequence number) or IEND; the type,
        position and length of the chunk that stopped it."""
        pos = len(SIGNATURE)
        while True:
            cid, length = self.header(pos)
            if self.call(cid, pos + 8, length):
                return cid, pos, length
            body = self.body(cid, pos + 8, length)
            crc = self.data[pos + 8 + length:pos + 12 + length]
            if len(crc) < 4:
                raise native.NotOpened(f"broken PNG file (incomplete "
                                       f"checksum in {cid!r})")
            if struct.unpack(">I", crc)[0] != zlib.crc32(cid + body):
                raise native.NotOpened(f"broken PNG file (bad header "
                                       f"checksum in {cid!r})")
            pos += 12 + length

    def image(self, pos: int, length: int):
        """ImageFile.load through PngImageFile.load_read: the data of the
        chunks of image data from the one at pos on (IDAT, DDAT or fdAT,
        their CRCs not checked), in Pillow's reads of at most 64 KB, each
        with the end of the chunk it was read from; it stops at any other
        chunk, or where the file does."""
        cid = self.data[pos + 4:pos + 8]
        skip = 4 if cid == b"fdAT" else 0
        start, left = pos + 8 + skip, length - skip
        while True:
            while left > 0:
                piece = self.data[start:start + min(left, 1 << 16)]
                if not piece:
                    return
                start += len(piece)
                left -= len(piece)
                yield piece, start + left
            pos = start + 4                           # past the CRC
            try:
                cid, length = self.header(pos)
            except native.NotOpened:
                return
            if cid not in (b"IDAT", b"DDAT", b"fdAT"):
                return
            if cid == b"fdAT":
                self.call(cid, pos + 8, length)
            skip = 4 if cid == b"fdAT" else 0
            start, left = pos + 8 + skip, length - skip

    def end(self, pos: int, animated: bool) -> None:
        """PngImageFile.load_end from the end of the chunk the last data
        were read from (pos): the chunks after it up to IEND, a chunk
        header cut short or broken, or an APNG's next fcTL, each through
        its handler, whose errors raise."""
        self.loaded = True
        while True:
            pos += 4                                  # the CRC, unread
            try:
                cid, length = self.header(pos)
            except native.NotOpened:
                return
            if cid == b"IEND" or (cid == b"fcTL" and animated):
                return
            try:
                data = self.call(cid, pos + 8, length)
            except native.NotOpened as e:
                raise ValueError(f"{e} (after the image data)") from None
            if data or cid not in _PNG_HANDLED:
                self.body(cid, pos + 8, length)
            pos += 8 + length


def _png_format(key, interlace: bool) -> str:
    """The IHDR's format, as "8-bit RGB PNG"; native.NotOpened where no
    IHDR named a colour type and bit depth Pillow has a mode for."""
    if key is None:
        raise native.NotOpened("PNG whose IHDR names no colour type and bit "
                               "depth Pillow has a mode for")
    depth, ctype = key
    return f"{depth}-bit {_NAMES[ctype]} PNG" + (" (Adam7)" if interlace
                                                 else "")


def _inflate(pieces, need: int, fmt: str) -> tuple[bytes, int]:
    """The image data inflated as far as the image needs, as Pillow's
    decoder reads it: a stream cut, or broken, after the last scanline's
    bytes still gives the image; ValueError where it gives fewer. Also the
    end of the chunk of the last data read."""
    d = zlib.decompressobj()
    out, got = [], 0
    try:
        for piece, end in pieces:
            out.append(d.decompress(piece))
            got += len(out[-1])
            if got >= need:
                return b"".join(out), end
    except zlib.error as e:
        raise ValueError(f"{fmt}: the image data does not inflate ({e})") \
            from None
    raise ValueError(f"{fmt}: the image data is truncated ({got} of the "
                     f"{need} bytes of its scanlines)")


def open_png(data: bytes) -> tuple:
    """PNG bytes -> the image as Pillow opens it (mode, pixels, palette;
    modes.rgb), row 0 = top: the chunks walked as PngImageFile walks them
    (_Png), the image data of the data chunks that follow one another from
    the first (into an APNG's fcTL frame where one comes before it, the
    rest of the image 0), then the chunks after them through their
    handlers."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    png = _Png(data)
    try:
        cid, pos, length = png.open()
    except ValueError as e:
        raise type(e)(f"{png.what()}: {e}") from None
    fmt = _png_format(png.key, png.interlace)
    if cid == b"IEND":
        raise ValueError(f"{fmt} without image data (IEND before IDAT): "
                         f"cannot load this image")
    depth, ctype = png.key
    width, height = png.size
    native.check_pixels(fmt, width, height)
    x0, y0, x1, y1 = png.bbox or (0, 0, width, height)
    fw, fh = x1 - x0, y1 - y0
    if fw <= 0 or fh <= 0:
        raise ValueError(f"{fmt}: an APNG frame of {fw}x{fh} pixels (tile "
                         f"cannot extend outside image)")
    ch = CHANNELS[ctype]
    passes = _ADAM7 if png.interlace else ((0, 0, 1, 1),)
    need = sum(ph * (1 + (pw * ch * depth + 7) // 8) for pw, ph in (
        (-(-(fw - px) // dx), -(-(fh - py) // dy))
        for px, py, dx, dy in passes) if pw > 0 and ph > 0)
    raw, end = _inflate(png.image(pos, length), need, fmt)
    frame = _pass_samples(raw, fw, fh, depth, ch, png.interlace)
    frames = (png.n_frames or 1) + int(png.n_frames is not None
                                       and png.default_image)
    png.end(end, frames > 1)
    px = np.zeros((height, width, ch), frame.dtype)
    px[y0:y1, x0:x1] = frame
    mode = _PNG_MODES[png.key]
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)   # past the end, or none: black
        if png.palette is not None:
            pal = np.frombuffer(png.palette, np.uint8)
            pal = pal[:len(pal) // 3 * 3].reshape(-1, 3)[:256]
            full[:len(pal)] = pal
        return mode, px[..., 0], full
    if ctype == 0 and depth == 16:                # I;16
        return mode, px[..., 0], None
    if depth == 16:                               # Pillow keeps the high byte
        px = (px >> 8).astype(np.uint8)
    elif depth < 8:                               # grey at 1, 2 or 4 bits
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 0:
        return mode, px[..., 0], None
    if ctype == 4:                                # grey + alpha
        return mode, modes.grey(px[..., 0]), None
    return mode, np.ascontiguousarray(px[..., :3]), None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB, row 0 = top, as Pillow's
    `convert("RGB")` gives them."""
    return modes.rgb(*open_png(data))


def _u32(data: bytes, order: str = "<") -> int:
    return struct.unpack_from(order + "I", data)[0] if len(data) >= 4 else -1


def _tried(header):
    """The test of a plugin that has no test of the first bytes: whether
    Image.open's try of it takes the file, its header opening or raising
    what escapes Image.open (a ValueError but native.NotOpened)."""
    def takes(data: bytes) -> bool:
        try:
            header(data)
        except native.NotOpened:
            return False
        except ValueError:
            pass
        return True
    return takes


_DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)


def _converted(decoder, mode: str):
    """The opener of a format whose files Pillow opens only in modes of
    several bands (mode names them): (mode, decoder's RGB, None)."""
    return lambda d: (mode, decoder(d), None)


# Pillow 12's image plugins in the order Image.open tries them (its six
# preinit plugins, then Image.ID's registration order), each with its test
# of the first bytes and, for the formats this loader reads, its opener:
# the image as Pillow opens it, (mode, pixels, palette) as modes.rgb takes
# it (a format whose files open only in modes of several bands: its RGB,
# `_converted`); the others (None) refuse the file. IM, IMT, IPTC and
# SPIDER have no test of the first bytes: Image.open runs their header
# check on every file that reaches them, so their row's test is that
# check (`_tried`: the header opens, or raises what escapes Image.open);
# PCD, which has none either, is in by its plugin's test of "PCD_" at
# byte 2048. IPTC opens its nested image through this walk (open_image).
_PILLOW_ORDER = (
    ("BMP", lambda d: d[:2] == b"BM", lambda d: open_bmp(d)),
    ("DIB", lambda d: _u32(d) in _DIB_SIZES, lambda d: open_dib(d, 0)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), gif.open_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", jpeg.open_file),
    ("PNM", pnm.accept, pnm.open_pnm),
    ("PNG", lambda d: d[:8] == SIGNATURE, lambda d: open_png(d)),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", blp.accept, _converted(blp.decode_blp, "RGB or RGBA")),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), None),
    ("CUR", ico.accept_cur, ico.open_cur),
    ("PCX", pcx.accept, pcx.open_pcx),
    ("DCX", pcx.accept_dcx, pcx.open_dcx),
    ("DDS", lambda d: d[:4] == dds.MAGIC, dds.open_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or _u32(d) == 0xC6D3D0C5, None),
    ("FITS", fits.accept, fits.open_fits),
    ("FLI", fli.accept, fli.open_fli),
    ("FTEX", ftex.accept, _converted(ftex.decode_ftex, "RGB or RGBA")),
    ("GBR", gbr.accept, gbr.open_gbr),
    ("GRIB", lambda d: d[:4] == b"GRIB" and len(d) >= 8 and d[7] == 1, None),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", None),
    ("JPEG 2000", jpeg2000.accept, jpeg2000.open_jp2),
    ("ICNS", icns.accept, icns.open_icns),
    ("ICO", ico.accept_ico, ico.open_ico),
    ("IM", _tried(im.header), im.open_im),
    ("IMT", _tried(imt.header), imt.open_imt),
    ("IPTC", _tried(iptc.header),
     lambda d: iptc.open_iptc(d, lambda n: open_image(n, in_memory=True))),
    ("McIdas", mcidas.accept, mcidas.open_mcidas),
    ("MPEG", lambda d: d[:4] == b"\x00\x00\x01\xb3", None),
    ("TIFF", lambda d: d[:4] in tiff.PREFIXES, tiff.open_tiff),
    ("MSP", msp.accept, msp.open_msp),
    ("PCD", pcd.accept, _converted(pcd.decode_pcd, "RGB")),
    ("PIXAR", pixar.accept, _converted(pixar.decode_pixar, "RGB")),
    ("PSD", lambda d: d[:4] == b"8BPS", psd.open_psd),
    ("QOI", qoi.accept, _converted(qoi.decode_qoi, "RGB or RGBA")),
    ("SGI", sgi.accept, sgi.open_sgi),
    ("SPIDER", _tried(spider.header), spider.open_spider),
    ("Sun raster", sun.accept, sun.open_sun),
    ("TGA", tga.header_ok, tga.open_tga),
    ("WebP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP",
     _converted(webp.decode_webp, "RGB or RGBA")),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00"
     or d[:4] == b"\x01\x00\x00\x00", None),
    ("XBM", xbm.accept, xbm.open_xbm),
    ("XPM", xpm.accept, xpm.open_xpm),
    ("XV thumbnail", xvthumb.accept, xvthumb.open_xvthumb))
# formats Pillow has no plugin for, named in the refusal
_OTHERS = ((b"#?RADIANCE", "Radiance HDR"), (b"\x76\x2f\x31\x01", "OpenEXR"),
           (b"P7", "PAM"), (b"PF", "colour PFM"))
READ = tuple(n for n, _, dec in _PILLOW_ORDER if dec is not None)


def format_of(data: bytes) -> str:
    """The image format that the file's first bytes name: the first of
    Pillow's plugins, in the order Image.open tries them, whose test of the
    first bytes takes the file ("PNG", "BMP", "DIB", "JPEG", "GIF", "PNM",
    "PSD", "TIFF", "DDS", "WebP", "TGA", "SGI", "PCX", "DCX", "QOI", "ICO",
    "CUR", "ICNS", "JPEG 2000", "BLP", "FTEX", "Sun raster", "XBM", "XPM",
    "GBR", "FLI", "MSP", "PCD", "PIXAR", "XV thumbnail", "FITS", "McIdas",
    "SPIDER", "IM", "IMT" or "IPTC" for the formats that decode here),
    else the name of another known format, or "unknown". TGA, which has
    no signature, comes by Pillow's test of its header; IM, IMT, IPTC and
    SPIDER by their header checks, where Image.open runs them. decode_image
    goes on to the next format where this one's header cannot be opened,
    as Image.open does."""
    for name, accept, _ in _PILLOW_ORDER:
        if accept(data):
            return name
    for sig, name in _OTHERS:
        if data.startswith(sig):
            return name
    return "unknown"


def _refusal(fmt: str, data: bytes) -> str:
    what = ("an image of unknown format (its first bytes are "
            f"{data[:8]!r})" if fmt == "unknown" else f"a {fmt} file")
    names = ("PNG",) + tuple(n for n in READ if n != "PNG")
    return (f"{what}, not a {', '.join(names[:-1])} or {names[-1]} file: "
            f"{fmt} images are not supported")


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> [H, W, 3] uint8 RGB, row 0 = top: open_image's
    image, as Pillow's convert("RGB") converts it."""
    return modes.rgb(*open_image(data))


# the openers of bytes Pillow opens from memory, where they read other
# than from a file: McIdas maps a file, and never bytes in memory
_IN_MEMORY = {"McIdas": lambda d: mcidas.open_mcidas(d, from_file=False)}


def open_image(data: bytes, in_memory: bool = False) -> tuple:
    """Image file bytes -> the image as Pillow's Image.open opens it:
    (mode, pixels, palette) as modes.rgb takes them (the pixels of one
    band for 1, L, P and the I;16 modes, RGB for the others). The format
    is chosen by the signature, in Pillow's order: where a format's test
    takes the file but its header cannot be opened (native.NotOpened), the
    next format whose test takes it is tried, as Image.open does.
    ValueError naming the format for any other format, and for a file its
    decoder cannot read. in_memory: bytes Pillow opens from memory (an
    IPTC stream's nested image), not from a file."""
    failed = []
    for name, accept, opener in _PILLOW_ORDER:
        if not accept(data):
            continue
        if opener is None:
            raise ValueError(_refusal(name, data))
        if in_memory:
            opener = _IN_MEMORY.get(name, opener)
        try:
            return opener(data)
        except native.NotOpened as e:
            failed.append(f"{name}: {e}")
        except ValueError as e:
            if name in str(e):                # the message names the format
                raise
            raise ValueError(f"{name}: {e}") from None
    if failed:
        raise ValueError(f"{'; '.join(failed)}: not opened, and no other "
                         f"format opens the file")
    raise ValueError(_refusal(format_of(data), data))


def load_image(path: str) -> Image:
    """stb_image-style load of a file of any format decode_image reads:
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
    bytes, realigned to an even offset in the file; a stream that ends, or
    stops, before the last pixel is an error."""
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
    if len(out) < total:
        # Pillow's set_as_raw: "not enough image data"
        raise ValueError(f"BMP run-length data end after {len(out)} of "
                         f"the {total} pixels")
    return np.frombuffer(bytes(out[:total]), np.uint8)


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
    return modes.rgb(*open_bmp(data))


def open_bmp(data: bytes) -> tuple:
    """BMP bytes -> the image as Pillow opens it (open_dib)."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ValueError("not a BMP file")
    return open_dib(data, 14, struct.unpack_from("<I", data, 10)[0])


# Pillow's BmpImagePlugin: the bitfield masks it reads, by depth (32-bit:
# red, green, blue, alpha)
_BITFIELDS = {
    32: ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
         (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)),
    24: ((0xFF0000, 0xFF00, 0xFF),),
    16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def decode_dib(data: bytes, pos: int, offset: int = 0,
               halve: str = "") -> np.ndarray:
    """The device-independent bitmap whose header starts at data[pos] ->
    [H, W, 3] uint8 RGB, row 0 = top (open_dib's image, converted)."""
    return modes.rgb(*open_dib(data, pos, offset, halve))


def open_dib(data: bytes, pos: int, offset: int = 0, halve: str = "",
             ) -> tuple:
    """The device-independent bitmap whose header starts at data[pos] ->
    the image (mode, pixels, palette; modes.rgb), row 0 = top, as Pillow's
    BmpImageFile._bitmap reads it: the pixels at `offset` (a BMP file's), or where none is given
    (0: a bare DIB, an icon's or a cursor's entry) right after the header,
    its bitfield masks and its palette. halve ("ICO" or "CUR"): an entry of
    an icon or a cursor, whose height counts the AND mask's rows too, so is
    halved (after Pillow's test of an empty image for an icon, before it for
    a cursor). native.NotOpened where Pillow's plugin cannot open it: a
    header cut before its size, an empty image."""
    if pos + 4 > len(data):
        raise native.NotOpened("the bitmap header is cut before its size")
    hsize = struct.unpack_from("<I", data, pos)[0]
    if pos + hsize > len(data):
        raise ValueError(f"the {hsize}-byte bitmap header is truncated")
    info = data[pos + 4:pos + hsize]
    masks, extra = None, 0
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
                alpha = (struct.unpack_from("<I", info, 48)[0]
                         if hsize >= 56 else 0)
            else:
                if pos + hsize + 12 > len(data):
                    raise ValueError("the bitmap's bitfield masks are "
                                     "truncated")
                masks = struct.unpack_from("<III", data, pos + hsize)
                alpha, extra = 0, 12
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
    if comp == 3 and (masks + (alpha,) if bits == 32 else masks) not in \
            _BITFIELDS[bits]:
        raise ValueError(f"{fmt}: bitfield masks {masks} are not a layout "
                         f"Pillow reads")
    if halve == "CUR":
        h //= 2
    if w <= 0 or h <= 0:
        raise native.NotOpened(f"{fmt} of {w}x{h} pixels")
    if halve == "ICO":
        h //= 2
        if not h:
            raise ValueError(f"{fmt}: an icon entry of one row, which holds "
                             f"no image rows")
    colors = colors or 1 << bits
    pal_at = pos + hsize
    if not offset:
        offset = pal_at + extra + (entry * colors if bits <= 8 else 0)
    elif offset == 14 + hsize and bits <= 8:          # as Pillow reads it
        offset += 4 * colors
    if comp in (1, 2):
        idx = _rle_indices(data, offset, w, h, comp == 2)
        px = idx.reshape(h, w)
    else:
        rows = native.raw_rows(data, offset, h, ((w * bits + 31) >> 3) & ~3,
                               (w * bits + 7) // 8, fmt)
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
    palette = None
    if bits <= 8:
        pal = np.frombuffer(data, np.uint8, entry * colors, pal_at)
        pal = pal.reshape(colors, entry)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else np.arange(colors)
        if (pal == np.asarray(ramp)[:, None]).all() and colors <= 256:
            # a grey palette: Pillow reads the indices as grey levels
            mode, rgb = ("1", px * np.uint8(255)) if colors == 2 else (
                "L", px)
        else:
            mode, rgb = "P", px
            palette = np.zeros((256, 3), np.uint8)    # past the end: black
            palette[:min(colors, 256)] = pal[:256]
    else:
        mode = "RGBA" if bits == 32 and comp == 3 and alpha else "RGB"
        if masks is None:
            masks = {16: (0x7C00, 0x3E0, 0x1F), 24: (0xFF0000, 0xFF00, 0xFF),
                     32: (0xFF0000, 0xFF00, 0xFF)}[bits]
        elif bits == 32 and masks == (0, 0, 0):       # Pillow: BGRA
            masks = (0xFF0000, 0xFF00, 0xFF)
        rgb = np.stack([_channel(px, m) for m in masks], axis=-1)
    return mode, np.ascontiguousarray(rgb if top_down else rgb[::-1]), \
        palette


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
