"""Old-style JPEG in TIFF (compression 6), as libtiff 4.7's tif_ojpeg.c
reads it under Pillow 12: the JPEG stream the codec builds from the TIFF's
tags and striles (strips or tiles), decoded by the port's JPEG decoder
(native/cge_jpeg.cpp) as libjpeg decodes it there.

libtiff reads one byte stream: the JPEGInterchangeFormat bytes (tag 513,
JPEGInterchangeFormatLength bytes or to the end of the file), then each
strile's bytes in turn. It parses markers from its start while they come
(SOI, APPn and COM skipped, DRI, DQT, DHT, SOF0, SOF1 or SOF3 with its
checks against the image and the strile, SOS); where the stream holds no
frame header it takes the tables from the tags instead: JPEGQTables (519,
64 bytes each), JPEGDCTables and JPEGACTables (520, 521: 16 counts and the
values), a table a sample, one at an offset shared with the sample before
reused, under a baseline frame of the strile's width and the strile rows'
height with component ids 0, 1, 2. It then hands libjpeg SOI, the
quantisation tables, the DC and AC tables, DRI, the frame and scan
headers it rebuilt (Ss 0, Se 63, Ah Al 0), what is left of the byte
stream with a restart marker after each strile but the last, and EOI.
Where a strile is shorter than the image, the restart interval is the
MCUs of a strile (which must be a whole number of MCU rows) unless the
stream's DRI says otherwise; else it is JPEGRestartInterval's (515), or
the stream's. Tiles lie one under another in a frame one tile wide.

Grey (one sample) comes out as libjpeg decodes it, no colour conversion;
three samples are YCbCr (libtiff takes photometric RGB, and a missing one,
for YCbCr) and come out as raw data (jpeg_read_raw_data: each component
at its own sampling, which the frame gives, whatever YCbCrSubsampling
says), which tiff.py converts as libtiff's TIFFRGBAImage does. A frame
whose first factors are not 1, 2 or 4, or whose other components are not
1x1, libtiff would have libjpeg desubsample, but it then expects factors
of 1 from jpeg_start_decompress and refuses the frame: so does this
module. In separate planes each plane is a one-component stream from its
own SOS (OJPEGReadSecondarySos), 1x1 only (libtiff's RGBA path converts
no other planes). Pillow reads the striles in order, and each takes its
lines from where libtiff's decoding stands (strip_lines): in a big-endian
file libtiff skips a strile before each strile after the first, so later
striles hold later lines, or none (a grey row then keeps what Pillow's
buffer held, raw YCbCr repeats the last iMCU row). Other sample counts
and lossless JPEGProc raise; what libtiff refuses raises too, and so do
raw lines of blocks libjpeg never writes (libtiff's uninitialised buffer
in Pillow). Where libtiff's search for plane 1's SOS fails, plane 0's
libjpeg session stays live and reads each later strile of plane 0 from
where that search stopped (_planes follows OJPEGPreDecode's rules); the
one case not followed, a stop before the last OJPEG_BUFFER bytes of its
strile with a third strile to read, where libjpeg's read-ahead points into
the buffer each search refills, is refused, naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from cge_tpu_torch import native

# the frame headers libtiff takes: SOF0, SOF1, SOF3
SOF = (0xC0, 0xC1, 0xC3)
# tif_ojpeg.c's OJPEG_BUFFER: the bytes of a strile libtiff reads at a time
_BUFFER = 2048


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
    each strip's or tile's, read a byte at a time."""

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

    def rest(self, at: tuple) -> bytes:
        """What is left from the place `at` (part, position) on, a restart
        marker after each strile but the last (numbered from RST0), and
        EOI."""
        out, rst = bytearray(), 0
        self.part, self.pos = at
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


def _parts(data, tags, desc, off_tag, cnt_tag) -> list:
    """(kind, bytes) in libtiff's reading order: the JPEGInterchangeFormat
    bytes, then each strile's ("strip")."""
    parts = []
    jif = _scalar(tags, 513, 0, (1 << 64) - 1)
    if jif and jif < len(data):
        n = _scalar(tags, 514, 0, (1 << 64) - 1)
        if not n or jif + n > len(data):
            n = len(data) - jif
        parts.append(("jif", data[jif:jif + n]))
    offsets = _list(tags.get(off_tag, ()))
    counts = _list(tags.get(cnt_tag, ()))
    if len(counts) < len(offsets):
        raise ValueError(f"{desc}: fewer byte counts than offsets of its "
                         f"strips or tiles")
    for off, n in zip(offsets, counts):
        if not off or off >= len(data):
            parts.append(("strip", b""))
            continue
        if not n or off + n > len(data):
            n = len(data) - off
        parts.append(("strip", data[off:off + n]))
    return parts


def _striles(tags, width, height, desc) -> tuple:
    """libtiff's striles (OJPEGReadHeaderInfo): (strile width, strile
    length, the lines of all strile rows, striles a plane, offset and
    byte count tags): strips of RowsPerStrip (the image's height where
    missing, not one positive integer or taller), or tiles."""
    if 322 in tags:
        tw, th = tags[322], tags.get(323)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 \
                or th <= 0:
            raise ValueError(f"{desc} with {tw}x{th} tiles")
        native.check_pixels(f"{desc}'s {tw}x{th} tile", tw, th)
        down = -(-height // th)
        return tw, th, down * th, -(-width // tw) * down, 324, 325
    rps = _list(tags.get(278, height))[0]
    rps = min(rps, height) if isinstance(rps, int) and rps > 0 else height
    return width, rps, height, -(-height // rps), 273, 279


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


def streams(data, tags, width, height, spp, ycbcr, desc):
    """The JPEG streams libtiff hands libjpeg, one a plane (one for
    PlanarConfiguration 1, one a sample for 2): (streams, the frame's
    first sampling factors (h, v), _striles(...), resumed). A plane after
    the first starts at the next SOS that OJPEGReadSecondarySos finds in
    the byte stream after the one before it; None where it finds none,
    b"" where the SOS names another component than the plane's (libjpeg
    refuses its header). resumed, where plane 1's search stops in a corrupt
    SOS: the stream plane 0's libjpeg session reads on from there (plane
    0's headers, then the bytes from where the search stopped), and
    whether that is in the last OJPEG_BUFFER bytes of its strile; else
    None."""
    sw, sl, total, _, off_tag, cnt_tag = layout = _striles(tags, width,
                                                           height, desc)
    planar = spp > 1 and tags.get(284, 1) == 2
    per_plane = 1 if planar else spp
    if spp not in (1, 3):
        raise ValueError(f"{desc}: SamplesPerPixel {spp} not supported for "
                         f"this compression scheme (libtiff)")
    proc = _scalar(tags, 512, 1, 65535)
    if proc != 1:
        raise ValueError(f"{desc}: JPEGProc {proc} (lossless) is not ported")
    restart = _scalar(tags, 515, 0, 65535)
    dri = None
    s = _Stream(_parts(data, tags, desc, off_tag, cnt_tag))
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
                if y < height and y < total:
                    raise ValueError("JPEG compressed data indicates "
                                     "unexpected height")
                if x < width and x < sw:
                    raise ValueError(f"JPEG compressed data indicates "
                                     f"unexpected width ({x}, not {sw})")
                if x > sw:
                    raise ValueError(f"JPEG compressed data image width "
                                     f"exceeds expected image width ({x}, "
                                     f"not {sw})")
                if s.byte() != spp:
                    raise ValueError("Corrupt SOF marker in JPEG data")
                comps = [s.block(3) for _ in range(spp)]
                sof = (m, y, x, comps)
            elif m == 0xDA:                                 # SOS
                sos = _sos(s, sof, per_plane)
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
        sof = (0xC0, total, sw, comps)
        sos = [bytes((c, tda[c])) for c in range(per_plane)]
        tables = {(kind, key): seg for kind, key, seg in segs}
    if sos is None:                      # no SOS read: OJPEGState's zeros
        sos = [bytes(2)] * per_plane
    marker, y, x, comps = sof
    hs, vs = comps[0][1] >> 4, comps[0][1] & 15
    factors = ",".join(f"{c[1] >> 4}x{c[1] & 15}" for c in comps)
    if spp == 1 or not ycbcr:
        if comps[0][1] != 0x11:
            raise ValueError(f"{desc}: JPEG compressed data indicates "
                             f"unexpected subsampling values")
    elif hs not in (1, 2, 4) or vs not in (1, 2, 4) or any(
            c[1] != 0x11 for c in comps[1:]):
        # OJPEGSubsamplingCorrect would have libjpeg desubsample, with the
        # subsampling taken as 1x1, which jpeg_start_decompress's factors
        # then contradict
        raise ValueError(
            f"{desc}: a JPEG sampled {factors}: libtiff refuses it "
            f"(jpeg_start_decompress() returned max_h_samp_factor = "
            f"{max(c[1] >> 4 for c in comps)} and max_v_samp_factor = "
            f"{max(c[1] & 15 for c in comps)}, expected 1 and 1)")
    elif planar and (hs, vs) != (1, 1):
        raise ValueError(f"{desc}: a JPEG sampled {factors} in separate "
                         f"planes: libtiff has no RGBA conversion of YCbCr "
                         f"subsampled {hs},{vs} (planar)")
    if sl < height:
        # OJPEGReadHeaderInfo: a restart interval of a strile's MCUs
        if sl % (vs * 8):
            raise ValueError(f"{desc}: Incompatible vertical subsampling and "
                             f"image strip/tile length")
        restart = -(-sw // (hs * 8)) * (sl // (vs * 8))
    if dri is not None:
        restart = dri
    head = b"\xff\xd8" + b"".join(
        tables[key] for key in [("dqt", i) for i in range(4)]
        + [("dht", i) for i in range(4)] + [("dht", 16 | i) for i in range(4)]
        if key in tables)
    if restart:
        head += struct.pack(">HHH", 0xFFDD, 4, restart)
    # where each plane's data start (OJPEGReadSecondarySos's sos_end);
    # where plane 1's search fails, where it stopped
    ends, lost = [(s.part, s.pos)], None
    for k in range(1, spp if planar else 1):
        sos += [None]
        at = None
        if ends[-1] is not None:
            try:
                s.part, s.pos = ends[-1]
                if _find_sos(s):
                    sos[-1] = _sos(s, sof, 1)[0]
                    at = (s.part, s.pos)
            except ValueError:
                pass
        ends.append(at)
        if k == 1 and at is None and s.peek() is not None:
            lost = (s.part, s.pos)

    def stream(k: int, at: tuple) -> bytes:
        plane = comps[k:k + 1] if planar else comps
        return (head + struct.pack(
            ">BBHBHHB", 0xFF, marker, 8 + 3 * per_plane, 8, y, x, per_plane)
            + b"".join(plane)
            + struct.pack(">HHB", 0xFFDA, 6 + 2 * per_plane, per_plane)
            + b"".join(sos[k:k + 1] if planar else sos) + b"\x00\x3f\x00"
            + s.rest(at))

    # jpeg_read_header's "Invalid component ID": b"", which no header takes
    out = [None if at is None else stream(k, at) if sos[k][0] == comps[k][0]
           else b"" for k, at in enumerate(ends)]
    if lost:
        # libtiff reads a strile into its buffer OJPEG_BUFFER bytes at a
        # time: whether the search stopped in the last window of its strile
        part, pos = lost
        lost = stream(0, lost), (len(s.parts[part][1]) - pos // _BUFFER
                                 * _BUFFER <= _BUFFER)
    return out, (hs, vs), layout, lost


def _sos(s: _Stream, sof, n: int) -> list:
    """OJPEGReadHeaderInfoSecStreamSos: the Cs, Td / Ta pairs of an SOS of
    n components, Ss, Se, Ah and Al skipped."""
    if not sof:
        raise ValueError("Corrupt SOS marker in JPEG data")
    if s.word() != 6 + 2 * n or s.byte() != n:
        raise ValueError("Corrupt SOS marker in JPEG data")
    sos = [s.block(2) for _ in range(n)]
    s.skip(3)
    return sos


def _find_sos(s: _Stream) -> bool:
    """OJPEGReadSecondarySos's search: on to the next 0xFF (0xFF...) 0xDA;
    False where the stream ends first."""
    while s.peek() is not None:
        if s.byte() == 0xFF:
            m = s.byte() if s.peek() is not None else 0
            while m == 0xFF and s.peek() is not None:
                m = s.byte()
            if m == 0xDA:
                return True
    return False


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


def _origin(k: int, sw: int, sl: int, width: int, tiled: bool) -> tuple:
    """The image row and column where strile k of a plane starts."""
    if not tiled:
        return k * sl, 0
    ty, tx = divmod(k, -(-width // sw))
    return ty * sl, tx * sw


_RESYNC = ("{}: LibJpeg: Unexpected error (libtiff's old-style JPEG source "
           "does not resynchronise at a restart marker)")


def _lines(jpeg: bytes, sw: int) -> tuple:
    """A one-component stream's lines through libtiff's source: (lines,
    the MCU row where the source failed or -1, the frame's height);
    ValueError where libjpeg refuses its header or its start."""
    w, sof_y = native.jpeg_tiff_info(b"", jpeg, 0)[:2]
    if w != sw:
        raise ValueError(f"jpeg_start_decompress() returned image_width = "
                         f"{w}, expected {sw}")
    return (*native.jpeg_tiff_lines(jpeg), sof_y)


def _planes(jpegs, resumed, sw, sl, count, column, width, height, tiled,
            desc) -> list:
    """The planes of a planar file as Pillow's RGBA path reads them
    (TIFFRGBAImageGet a strip, or a row of tiles, each call reading each
    strile's planes in turn) through libtiff's
    OJPEGPreDecode: a plane's read starts its own libjpeg session, which
    ends that of another plane (or of a later strile of its own), and
    skips to its strile; a session stays where it is between striles. A
    plane whose SOS OJPEGReadSecondarySos does not find fails before that
    (plane 2's search goes through plane 1's), so a failed search of plane
    1 leaves plane 0's session live, reading its next strile (a restart
    interval) from where the search stopped: in a corrupt SOS (resumed),
    or at the end, where the strile's decoding fails and the skip to the
    next one fails. Once libjpeg refuses a header, libtiff starts no
    session again. A read that fails leaves zeros (libtiff clears the
    buffer), but where it fails before decoding and is the call's first
    (plane 0 of its first strile), TIFFRGBAImageGet fails and Pillow with
    it."""
    lines = []
    for p, jpeg in enumerate(jpegs):
        try:
            lines.append(_lines(jpeg, sw) if jpeg else None)
        except ValueError as e:
            if p == 0:
                raise ValueError(f"{desc}: {e}") from None
            lines.append(None)
    last_window = True
    if resumed is not None:
        resumed, last_window = resumed
        try:
            resumed = _lines(resumed, sw)
        except ValueError as e:
            raise ValueError(f"{desc}: plane 0's libjpeg session reading on "
                             f"from plane 1's corrupt SOS marker: {e}") \
                from None
    out = [np.zeros((height, width), np.uint8) for _ in jpegs]
    session, stuck, moved = None, False, False
    per_call = -(-width // sw) if tiled else 1
    for k in range(count):
        n = min(sl, column - k * sl)
        r0, c0 = _origin(k, sw, sl, width, tiled)
        for p, jpeg in enumerate(jpegs):
            # the lines read, and whether OJPEGPreDecode passed (a read
            # that fails leaves zeros)
            got, started = None, False
            if jpeg is None:
                moved |= p == 1
            else:
                if session and (session[0] != p or session[1] > k):
                    session = None
                if session is None and not stuck:
                    stuck = lines[p] is None
                    session, moved = (None if stuck else [p, 0]), False
                if session is None:
                    pass
                elif moved and resumed is None:
                    # at the stream's end: the strile's decoding fails, and
                    # so does every later skip to the next one
                    started = session[1] == k
                elif moved and not last_window and session[1] > 1:
                    # the strile before read on from where the search
                    # stopped, and may have read past its window: libjpeg's
                    # read-ahead then points into the buffer each search
                    # refills with that window
                    raise ValueError(
                        f"{desc}: plane 1's corrupt SOS marker lies before "
                        f"the last {_BUFFER}-byte window of its strile, and "
                        f"plane 0's libjpeg session reads its strile {k} "
                        f"on from bytes each search of libtiff's refills "
                        f"(not followed)")
                else:
                    rows, failed, sof_y = resumed if moved else lines[p]
                    first = 0 if moved else k * sl
                    if failed >= 0 and min(first + n, sof_y) > 8 * failed:
                        raise ValueError(_RESYNC.format(desc))
                    got = rows[first:min(first + n, sof_y)]
                    session[1], started = k + 1, True
            if not started and p == 0 and k % per_call == 0:
                raise ValueError(f"{desc}: libtiff cannot start plane 0's "
                                 f"strile {k} (its libjpeg session cannot "
                                 f"start, or skip to it, after plane 1's "
                                 f"reads failed), so TIFFRGBAImageGet fails")
            buf = np.zeros((n, sw), np.uint8)
            if got is not None:
                buf[:len(got)] = got
            part = buf[:height - r0, :width - c0]
            out[p][r0:r0 + part.shape[0], c0:c0 + part.shape[1]] = part
    return out


def decode(data, tags, width, height, spp, ycbcr, desc):
    """The image's samples as libtiff hands them to Pillow, strile by
    strile, each placed where it lies in the image: grey [height, width]
    uint8, or YCbCr (Y, Cb, Cr) [height, width] uint8 each, the chroma
    held over each block of the frame's sampling (h, v) within its strile,
    and (h, v).

    Grey reads its striles' lines (strip_lines) as scanlines, a line past
    the decoding's last keeping what Pillow's strip or tile buffer held.
    Planes are read as Pillow's RGBA path reads them (_planes): each
    strile of a plane restarts its stream, so it reads from its own lines
    on (a line past the decoding's last zeroed); a plane after the first
    whose SOS libtiff does not find or libjpeg refuses reads as zeros, and
    where plane 1's search fails plane 0's later striles read on from
    where it stopped.
    YCbCr in one plane is raw data, a line past the last iMCU row read as
    the conversion buffer keeps that row. Where the source fails at a
    restart marker that a strile's reads reach (a frame taller than the
    image may fail past them, unread), grey and planes raise (Pillow's
    strip reader stops), and so does YCbCr, unless the failing MCU row is
    reached in the decoding of the last strile, which then reads as zeros
    (libtiff leaves a strile it fails to decode as it cleared it, and
    Pillow's RGBA path goes on; a later strile's skip fails again, and
    Pillow's RGBA path stops there). A line of blocks that libjpeg leaves
    out of its raw data (past a component's own height) is libtiff's
    uninitialised buffer: an error here."""
    jpegs, (hs, vs), (sw, sl, _, count, _, _), resumed = streams(
        data, tags, width, height, spp, ycbcr, desc)
    tiled = 322 in tags
    swapped = data[:2] == b"MM"
    # the striles' lines in one column: strips as they are, each tile full
    column = count * sl if tiled else height
    if len(jpegs) > 1:
        planes = _planes(jpegs, resumed, sw, sl, count, column, width,
                         height, tiled, desc)
        return (*planes, (hs, vs))
    if spp == 1:
        try:
            rows, failed, sof_y = _lines(jpegs[0], sw)
        except ValueError as e:
            raise ValueError(f"{desc}: {e}") from None
        strips = strip_lines(column, sl, 1, swapped)
        # Pillow's strip reader stops at a strile whose reads reach the
        # failing MCU row (those past the frame's lines read nothing)
        if failed >= 0 and any(min(first + n, sof_y) > 8 * failed
                               for _, _, first, n in strips):
            raise ValueError(_RESYNC.format(desc))
        out = np.zeros((height, width), np.uint8)
        buf = np.zeros((sl, sw), np.uint8)
        for k, (_, _, first, n) in enumerate(strips):
            for j in range(n):
                if first + j < sof_y:
                    buf[j] = rows[first + j]
            r0, c0 = _origin(k, sw, sl, width, tiled)
            part = buf[:min(n, height - r0), :width - c0]
            out[r0:r0 + part.shape[0], c0:c0 + part.shape[1]] = part
        return out
    jpeg = jpegs[0]
    try:
        w, sof_y = native.jpeg_tiff_info(b"", jpeg, 2)[:2]
        if w != sw:
            raise ValueError(f"jpeg_start_decompress() returned image_width "
                             f"= {w}, expected {sw}")
        (y, cb, cr), failed = native.jpeg_tiff_planes(jpeg)
    except ValueError as e:
        raise ValueError(f"{desc}: {e}") from None
    strips = strip_lines(column, sl, vs, swapped)
    total = cb.shape[0]                     # the iMCU rows' lines
    y_blocks, c_blocks = -(-sof_y // 8), -(-(-(-sof_y // vs)) // 8)
    cw = -(-sw // hs)
    out = np.zeros((3, height, width), np.uint8)
    for k, (top, start, first, n) in enumerate(strips):
        if failed >= 0 and max(start, 8 * failed) < min(first + n, total):
            # libtiff fails the strile whose reads reach the failing row;
            # where a skip of OJPEGPreDecode reaches it, or a strile
            # follows (whose skip calls libjpeg again), TIFFFillStrip fails
            # and Pillow's TIFFRGBAImageGet with it
            if 8 * failed < first or k + 1 < len(strips):
                raise ValueError(f"{desc}: LibJpeg: Unexpected error "
                                 f"(libtiff's old-style JPEG source does not "
                                 f"resynchronise at a restart marker, and "
                                 f"the strile after the one that fails "
                                 f"cannot be read)")
            break
        rows = min(sl, column - top)
        tile = np.zeros((3, n * vs, sw), np.uint8)
        for j in range(n):
            i = first + j
            if i >= total:                    # the last iMCU row again
                i = total - 8 + i % 8
            if (i * vs) // 8 >= y_blocks or i // 8 >= c_blocks:
                raise ValueError(f"{desc}: a strile reads raw data past a "
                                 f"component's blocks, which libjpeg leaves "
                                 f"unwritten (undefined in Pillow)")
            tile[0, j * vs:(j + 1) * vs] = y[i * vs:(i + 1) * vs, :sw]
            for c, plane in ((1, cb), (2, cr)):
                tile[c, j * vs:(j + 1) * vs] = np.repeat(
                    plane[i, :cw], hs)[:sw]
        r0, c0 = _origin(k, sw, sl, width, tiled)
        part = tile[:, :min(rows, height - r0), :width - c0]
        out[:, r0:r0 + part.shape[1], c0:c0 + part.shape[2]] = part
    return out[0], out[1], out[2], (hs, vs)
