"""Old-style JPEG in TIFF (compression 6), as libtiff 4.7's tif_ojpeg.c
reads it under Pillow 12: the JPEG stream the codec builds from the TIFF's
tags and strips, decoded by the port's JPEG decoder (native/cge_jpeg.cpp)
as libjpeg decodes it there.

libtiff reads one byte stream: the JPEGInterchangeFormat bytes (tag 513,
JPEGInterchangeFormatLength bytes or to the end of the file), then each
strip's bytes in turn. It parses markers from its start while they come
(SOI, APPn and COM skipped, DRI, DQT, DHT, SOF0, SOF1 or SOF3 with its
checks against the image, SOS); where the stream holds no frame header it
takes the tables from the tags instead: JPEGQTables (519, 64 bytes each),
JPEGDCTables and JPEGACTables (520, 521: 16 counts and the values), a
table a sample, one at an offset shared with the sample before reused,
under a baseline frame of the strips' width and the image's height with
component ids 0, 1, 2. It then hands libjpeg SOI, the quantisation
tables, the DC and AC tables, DRI, the frame and scan headers it rebuilt
(Ss 0, Se 63, Ah Al 0), what is left of the byte stream with a restart
marker after each strip but the last, and EOI. Where the image has more
than one strip, the restart interval is the MCUs of a strip (which must
be a whole number of MCU rows) unless the stream's DRI says otherwise;
with one strip it is JPEGRestartInterval's (515), or the stream's.

Grey (one sample) comes out as libjpeg decodes it, no colour conversion;
three samples are YCbCr (libtiff takes photometric RGB, and a missing one,
for YCbCr) and come out as raw data (jpeg_read_raw_data: each component
at its own sampling, which the frame gives, whatever YCbCrSubsampling
says), which tiff.py converts as libtiff's TIFFRGBAImage does. Pillow
reads the strips in order, and each takes its lines from where libtiff's
decoding stands (strip_lines): in a big-endian file libtiff skips a strip
before each strip after the first, so later strips hold later lines, or
none (a grey row then keeps what Pillow's buffer held, raw YCbCr repeats
the last iMCU row). Tiles, separate planes, other sample counts and a
frame whose sampling libtiff would undo inside libjpeg are not ported and
raise; what libtiff refuses raises too, and so do raw lines of blocks
libjpeg never writes (libtiff's uninitialised buffer in Pillow).
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

# the frame headers libtiff takes: SOF0, SOF1, SOF3
SOF = (0xC0, 0xC1, 0xC3)


def _list(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _scalar(tags, tag: int, default: int, top: int) -> int:
    """A tag libtiff reads as one integer (TIFFReadDirEntryShort or
    Long8): one value of an integer type from 0 to top, or the tag is not
    set (count, type or range refused) and reads as its default."""
    v = _list(tags.get(tag, default))
    if len(v) != 1 or not isinstance(v[0], int) or not 0 <= v[0] <= top:
        return default
    return v[0]


class _Stream:
    """libtiff's OJPEG byte stream: the JPEGInterchangeFormat bytes, then
    each strip's, read a byte at a time."""

    def __init__(self, parts: list):
        self.parts = parts
        self.part, self.pos = 0, 0

    def _skip_empty(self):
        while self.part < len(self.parts) and \
                self.pos >= len(self.parts[self.part][1]):
            self.part += 1
            self.pos = 0

    def peek(self):
        self._skip_empty()
        if self.part == len(self.parts):
            return None
        return self.parts[self.part][1][self.pos]

    def byte(self) -> int:
        b = self.peek()
        if b is None:
            raise ValueError("the stream ends in a marker segment")
        self.pos += 1
        return b

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def block(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int) -> None:
        """OJPEGReadSkip: n bytes, but none past the end of the part being
        read (libtiff does not skip into the next block)."""
        if self.part < len(self.parts):
            self.pos = min(self.pos + n, len(self.parts[self.part][1]))

    def rest(self) -> bytes:
        """What is left, a restart marker after each strip but the last
        (numbered from RST0), and EOI."""
        out, rst = bytearray(), 0
        self._skip_empty()
        while self.part < len(self.parts):
            kind, part = self.parts[self.part]
            out += part[self.pos:]
            self.part += 1
            self.pos = 0
            later = [p for k, p in self.parts[self.part:] if k == "strip"
                     and p]
            if kind == "strip" and later:
                out += bytes((0xFF, 0xD0 + rst))
                rst = (rst + 1) % 8
        return bytes(out) + b"\xff\xd9"


def _parts(data, tags, desc) -> list:
    """(kind, bytes) in libtiff's reading order."""
    parts = []
    jif = _scalar(tags, 513, 0, (1 << 64) - 1)
    if jif and jif < len(data):
        n = _scalar(tags, 514, 0, (1 << 64) - 1)
        if not n or jif + n > len(data):
            n = len(data) - jif
        parts.append(("jif", data[jif:jif + n]))
    offsets, counts = _list(tags.get(273, ())), _list(tags.get(279, ()))
    if len(counts) < len(offsets):
        raise ValueError(f"{desc}: fewer StripByteCounts than StripOffsets")
    for off, n in zip(offsets, counts):
        if not off or off >= len(data):
            parts.append(("strip", b""))
            continue
        if not n or off + n > len(data):
            n = len(data) - off
        parts.append(("strip", data[off:off + n]))
    return parts


def _tag_tables(data, tags, n, desc):
    """The tables of tags 519-521, as OJPEGReadHeaderInfoSecTables*:
    (DQT segments, DHT segments, each sample's quantisation table and
    Td / Ta selectors)."""
    segs, tq, tda = [], [0] * n, [0] * n
    for tag, what in ((519, "JPEGQTables"), (520, "JPEGDCTables"),
                      (521, "JPEGACTables")):
        offs = list(_list(tags.get(tag, (0,))))
        # not set: more than 3 offsets (OJPEGVSetField: "incorrect count"),
        # or values TIFFReadDirEntryLong8Array refuses (a type other than
        # an integer one, a negative one)
        if len(offs) > 3 or not all(isinstance(o, int) and o >= 0
                                    for o in offs):
            offs = []
        offs += [0] * (n - len(offs))
        if not offs[0]:
            raise ValueError(f"{desc}: Missing JPEG tables ({what})")
        for m in range(n):
            fresh = offs[m] and (m == 0 or offs[m] != offs[m - 1])
            if fresh and offs[m] in offs[:max(m - 1, 0)]:
                raise ValueError(f"{desc}: Corrupt {what} tag value")
            if not fresh:
                if tag == 519:
                    tq[m] = tq[m - 1]
                elif tag == 520:
                    tda[m] = tda[m - 1]
                else:
                    tda[m] |= tda[m - 1] & 15
                continue
            at = offs[m]
            if tag == 519:
                table = data[at:at + 64]
                if len(table) != 64:
                    raise ValueError(f"{desc}: {what} past the end of the "
                                     f"file")
                segs.append(("dqt", m, b"\xff\xdb\x00\x43" + bytes((m,))
                             + table))
                tq[m] = m
                continue
            counts = data[at:at + 16]
            total = sum(counts)
            values = data[at + 16:at + 16 + total]
            if len(counts) != 16 or len(values) != total:
                raise ValueError(f"{desc}: {what} past the end of the file")
            cls = 0 if tag == 520 else 16
            segs.append(("dht", cls | m, b"\xff\xc4" + struct.pack(
                ">H", 19 + total) + bytes((cls | m,)) + counts + values))
            tda[m] = (m << 4) if tag == 520 else (tda[m] | m)
    return segs, tq, tda


def stream(data, tags, width, height, spp, ycbcr, desc):
    """The JPEG stream libtiff hands libjpeg: (stream bytes, the frame's
    first sampling factors (h, v))."""
    if 322 in tags:
        raise ValueError(f"{desc}: old-style JPEG in tiles is not ported")
    if tags.get(284, 1) != 1 and len(_list(tags.get(273, ()))) > 1:
        raise ValueError(f"{desc}: old-style JPEG in separate planes is not "
                         f"ported")
    if spp not in (1, 3):
        raise ValueError(f"{desc}: SamplesPerPixel {spp} not supported for "
                         f"this compression scheme (libtiff)")
    proc = _scalar(tags, 512, 1, 65535)
    if proc != 1:
        raise ValueError(f"{desc}: JPEGProc {proc} (lossless) is not ported")
    rps = _list(tags.get(278, height))[0]
    rps = min(rps, height) if isinstance(rps, int) and rps > 0 else height
    restart = _scalar(tags, 515, 0, 65535)
    dri = None
    parts = _parts(data, tags, desc)
    s = _Stream(parts)
    tables = {}                          # ("dqt" / "dht", id) -> segment
    sof = sos = None
    try:
        while s.peek() == 0xFF:
            s.byte()
            m = s.byte()
            while m == 0xFF:
                m = s.byte()
            if m == 0xD8:                                   # SOI
                continue
            if m == 0xFE or 0xE0 <= m <= 0xEF:              # COM, APPn
                n = s.word()
                if n < 2:
                    raise ValueError("Corrupt JPEG data")
                s.skip(n - 2)
            elif m == 0xDD:                                 # DRI
                if s.word() != 4:
                    raise ValueError("Corrupt DRI marker in JPEG data")
                dri = s.word()
            elif m == 0xDB:                                 # DQT
                n = s.word()
                if n <= 2:
                    raise ValueError("Corrupt DQT marker in JPEG data")
                n -= 2
                while n > 0:
                    if n < 65:
                        raise ValueError("Corrupt DQT marker in JPEG data")
                    t = s.block(65)
                    if t[0] & 15 > 3:
                        raise ValueError("Corrupt DQT marker in JPEG data")
                    tables[("dqt", t[0] & 15)] = b"\xff\xdb\x00\x43" + t
                    n -= 65
            elif m == 0xC4:                                 # DHT
                n = s.word()
                if n <= 2:
                    raise ValueError("Corrupt DHT marker in JPEG data")
                body = s.block(n - 2)
                o = body[0]
                if (o & 0xF0) not in (0, 16) or o & 15 > 3:
                    raise ValueError("Corrupt DHT marker in JPEG data")
                tables[("dht", o)] = b"\xff\xc4" + struct.pack(">H", n) + body
            elif m in SOF:
                if sof:
                    raise ValueError("Corrupt JPEG data (a second SOF)")
                n = s.word()
                if n < 11 or (n - 8) % 3:
                    raise ValueError("Corrupt SOF marker in JPEG data")
                if (n - 8) // 3 != spp:
                    raise ValueError("JPEG compressed data indicates "
                                     "unexpected number of samples")
                if s.byte() != 8:
                    raise ValueError("JPEG compressed data indicates "
                                     "unexpected number of bits per sample")
                y, x = s.word(), s.word()
                if y < height:
                    raise ValueError("JPEG compressed data indicates "
                                     "unexpected height")
                if x != width:
                    raise ValueError(f"JPEG compressed data indicates a "
                                     f"width of {x}, not {width}")
                if s.byte() != spp:
                    raise ValueError("Corrupt SOF marker in JPEG data")
                comps = [s.block(3) for _ in range(spp)]
                sof = (m, y, x, comps)
            elif m == 0xDA:                                 # SOS
                if not sof:
                    raise ValueError("Corrupt SOS marker in JPEG data")
                if s.word() != 6 + 2 * spp or s.byte() != spp:
                    raise ValueError("Corrupt SOS marker in JPEG data")
                sos = [s.block(2) for _ in range(spp)]
                s.skip(3)                            # Ss, Se, Ah and Al
                break
            else:
                raise ValueError(f"Unknown marker type {m} in JPEG data")
    except ValueError as e:
        raise ValueError(f"{desc}: {e}") from None
    if sof is None:
        segs, tq, tda = _tag_tables(data, tags, spp, desc)
        hs, vs = _sampling(tags, ycbcr, spp)
        comps = [bytes((c, (hs << 4 | vs) if c == 0 else 0x11, tq[c]))
                 for c in range(spp)]
        sof = (0xC0, height, width, comps)
        sos = [bytes((c, tda[c])) for c in range(spp)]
        tables = {(kind, key): seg for kind, key, seg in segs}
    if sos is None:                      # no SOS read: OJPEGState's zeros
        sos = [bytes(2)] * spp
    marker, y, x, comps = sof
    hs, vs = comps[0][1] >> 4, comps[0][1] & 15
    if spp == 1 or not ycbcr:
        if comps[0][1] != 0x11:
            raise ValueError(f"{desc}: JPEG compressed data indicates "
                             f"unexpected subsampling values")
    elif hs not in (1, 2, 4) or vs not in (1, 2, 4) or any(
            c[1] != 0x11 for c in comps[1:]):
        factors = ",".join(f"{c[1] >> 4}x{c[1] & 15}" for c in comps)
        raise ValueError(f"{desc}: a JPEG sampled {factors}, which libtiff "
                         f"desubsamples inside libjpeg: not ported")
    if rps < height:
        # OJPEGReadHeaderInfo: a restart interval of a strip's MCUs
        if rps % (vs * 8):
            raise ValueError(f"{desc}: Incompatible vertical subsampling and "
                             f"image strip/tile length")
        restart = -(-width // (hs * 8)) * (rps // (vs * 8))
    if dri is not None:
        restart = dri
    head = b"\xff\xd8" + b"".join(
        tables[key] for key in [("dqt", i) for i in range(4)]
        + [("dht", i) for i in range(4)] + [("dht", 16 | i) for i in range(4)]
        if key in tables)
    if restart:
        head += struct.pack(">HHH", 0xFFDD, 4, restart)
    head += struct.pack(">BBHBHHB", 0xFF, marker, 8 + 3 * spp, 8, y, x, spp)
    head += b"".join(comps)
    head += struct.pack(">HHB", 0xFFDA, 6 + 2 * spp, spp) + b"".join(sos) \
        + b"\x00\x3f\x00"
    return head + s.rest(), (hs, vs)


def _sampling(tags, ycbcr, spp):
    """The sampling of a frame rebuilt from the tags: YCbCrSubsampling
    (libtiff's default 2, 2) for YCbCr, else 1, 1."""
    if spp == 1 or not ycbcr:
        return 1, 1
    sub = _list(tags.get(530, (2, 2)))
    hs, vs = (sub[0], sub[1]) if len(sub) >= 2 else (2, 2)
    if hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError(f"invalid YCbCr subsampling {hs},{vs}")
    return hs, vs


def strip_lines(height: int, rps: int, per_line: int, swapped: bool):
    """Where in the decoding each strip's lines come from, its strips read
    in order as Pillow reads them: [(the strip's first image row, the first
    line read for it, skips included; its first line; its count of
    lines)], a line being per_line image rows (YCbCr's v as raw data, 1
    for grey). libtiff counts the strips read in OJPEGPostDecode and skips
    a strip's lines (lines_per_strile) for each strip it is behind. In a
    file of swapped bytes (MM on a little-endian host) setting
    BitsPerSample, which libtiff reads after Compression, puts its own
    post-decode step in that one's place, so the count moves only by
    skipping: each strip after the first comes after a skipped one."""
    per_strip = -(-rps // per_line)
    out, at, counted = [], 0, 0
    for s in range(-(-height // rps)):
        lines = -(-min(rps, height - s * rps) // per_line)
        start = at
        at += (s - counted) * per_strip          # OJPEGPreDecode's skips
        counted = s
        out.append((s * rps, start, at, lines))
        at += lines
        if not swapped:
            counted += 1                         # OJPEGPostDecode
    return out


def decode(data, tags, width, height, spp, ycbcr, desc):
    """The image's samples as libtiff hands them to Pillow, strip by strip
    (strip_lines): grey [height, width] uint8, a line past the decoding's
    last leaving the row Pillow's strip buffer held; or YCbCr as (Y
    [height, width], Cb, Cr [ceil(height / v), ceil(width / h)], (h, v)),
    a line past the last iMCU row read as the conversion buffer keeps that
    row. Where the source fails at a restart marker that a strip's reads
    reach (a frame taller than the image may fail past them, unread), grey
    raises (Pillow's strip reader stops), and so does YCbCr, unless the
    failing MCU row is reached in the decoding of the last strip, which
    then reads as zeros (libtiff leaves a strip it fails to decode as it
    cleared it, and Pillow's RGBA path goes on; a later strip's skip fails
    again, and Pillow's RGBA path stops there). A line
    of blocks that libjpeg leaves out of its raw data (past a component's
    own height) is libtiff's uninitialised buffer: an error here."""
    jpeg, (hs, vs) = stream(data, tags, width, height, spp, ycbcr, desc)
    rps = _list(tags.get(278, height))[0]
    rps = min(rps, height) if isinstance(rps, int) and rps > 0 else height
    swapped = data[:2] == b"MM"
    try:
        w, sof_y = native.jpeg_tiff_info(b"", jpeg, 2 if spp == 3 else 0)[:2]
        if w != width:
            raise ValueError(f"jpeg_start_decompress() returned image_width "
                             f"= {w}, expected {width}")
        if spp == 1:
            rows, failed = native.jpeg_tiff_lines(jpeg)
        else:
            (y, cb, cr), failed = native.jpeg_tiff_planes(jpeg)
    except ValueError as e:
        raise ValueError(f"{desc}: {e}") from None
    strips = strip_lines(height, rps, 1 if spp == 1 else vs, swapped)
    if spp == 1:
        # grey: Pillow's strip reader stops at a strip whose reads reach the
        # failing MCU row (those past the frame's lines read nothing)
        if failed >= 0 and any(min(first + n, sof_y) > 8 * failed
                               for _, _, first, n in strips):
            raise ValueError(f"{desc}: LibJpeg: Unexpected error (libtiff's "
                             f"old-style JPEG source does not resynchronise "
                             f"at a restart marker)")
        out = np.empty((height, width), np.uint8)
        buf = np.zeros((rps, width), np.uint8)       # Pillow's strip buffer
        for top, _, first, n in strips:
            for j in range(n):
                if first + j < sof_y:
                    buf[j] = rows[first + j]
            out[top:top + n] = buf[:n]
        return out
    total = cb.shape[0]                     # the iMCU rows' lines
    y_blocks, c_blocks = -(-sof_y // 8), -(-(-(-sof_y // vs)) // 8)
    cw = -(-width // hs)
    out_y = np.zeros((height, width), np.uint8)
    out_c = np.zeros((2, -(-height // vs), cw), np.uint8)
    for k, (top, start, first, n) in enumerate(strips):
        if failed >= 0 and max(start, 8 * failed) < min(first + n, total):
            # libtiff fails the strip whose reads reach the failing row;
            # where a skip of OJPEGPreDecode reaches it, or a strip follows
            # (whose skip calls libjpeg again), TIFFFillStrip fails and
            # Pillow's TIFFRGBAImageGet with it
            if 8 * failed < first or k + 1 < len(strips):
                raise ValueError(f"{desc}: LibJpeg: Unexpected error "
                                 f"(libtiff's old-style JPEG source does not "
                                 f"resynchronise at a restart marker, and "
                                 f"the strip after the one that fails cannot "
                                 f"be read)")
            break
        for j in range(n):
            i = first + j
            if i >= total:                    # the last iMCU row again
                i = total - 8 + i % 8
            if (i * vs) // 8 >= y_blocks or i // 8 >= c_blocks:
                raise ValueError(f"{desc}: a strip reads raw data past a "
                                 f"component's blocks, which libjpeg leaves "
                                 f"unwritten (undefined in Pillow)")
            r = top + j * vs
            k = min(vs, height - r)
            out_y[r:r + k] = y[i * vs:i * vs + k, :width]
            out_c[:, top // vs + j] = (cb[i, :cw], cr[i, :cw])
    return out_y, out_c[0], out_c[1], (hs, vs)
