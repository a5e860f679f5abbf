"""Probes of the last texture tails the port follows Pillow 12 on: JP2
colr boxes of CIELab at every size and the colr boxes after them, JPX
files (OpenJPEG 2.5.4 under Pillow), IM's bare "LAB" type over each
layout a type line leaves, and IPTC band images of every nested format
and mode Pillow writes. Each file goes through the port's
image_io.decode_image and through Pillow's Image.open(...).convert("RGB")
in a worker process (a nested image of mode I or F in band 0 makes
Pillow's merge read a null row pointer, and the worker dies): the same
pixels, or both refusing, or Pillow's worker dying where the port
refuses.

    JAX_PLATFORMS=cpu python3 jax_references/tail_probes.py [kind ...]

kind: colr, jpx, im, iptc, iptc_fixtures, ojpeg (default all). It prints each mismatch and the
counts; `pillow_rgb` is the worker the tests use too.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import subprocess
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402


# ------------------------------------------------------------ the worker

def _serve() -> None:
    """The worker's loop: a length-prefixed file on stdin, its pickled
    result on stdout: ("ok", RGB array) or ("error", type name, message)."""
    import warnings

    from PIL import Image as PILImage
    warnings.simplefilter("ignore")
    src, out = sys.stdin.buffer, sys.stdout.buffer
    while True:
        head = src.read(8)
        if len(head) < 8:
            return
        data = src.read(struct.unpack("<Q", head)[0])
        try:
            with PILImage.open(io.BytesIO(data)) as im:
                res = ("ok", np.asarray(im.convert("RGB")))
        except Exception as e:                     # noqa: BLE001
            res = ("error", type(e).__name__, str(e))
        blob = pickle.dumps(res)
        out.write(struct.pack("<Q", len(blob)) + blob)
        out.flush()


class _Worker:
    proc = None

    def call(self, data: bytes) -> tuple:
        if self.proc is None or self.proc.poll() is not None:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
        try:
            self.proc.stdin.write(struct.pack("<Q", len(data)) + data)
            self.proc.stdin.flush()
            head = self.proc.stdout.read(8)
            if len(head) == 8:
                return pickle.loads(self.proc.stdout.read(
                    struct.unpack("<Q", head)[0]))
        except BrokenPipeError:
            pass
        code = self.proc.wait()
        self.proc = None
        return ("died", code)

    def close(self) -> None:
        if self.proc is not None:
            self.proc.stdin.close()
            self.proc.wait()
            self.proc = None


_WORKER = _Worker()


def pillow_rgb(data: bytes) -> tuple:
    """JAX's loader on data, in a worker process: ("ok", [H, W, 3] uint8),
    ("error", Pillow's exception's name, its message) or ("died", the
    worker's exit code, negative for a signal)."""
    return _WORKER.call(data)


def port_rgb(data: bytes) -> tuple:
    """The port's decode_image on data: ("ok", pixels) or ("error",
    "ValueError", message)."""
    from cge_tpu_torch.scene import image_io
    try:
        return ("ok", image_io.decode_image(data))
    except ValueError as e:
        return ("error", "ValueError", str(e))


def agree(data: bytes) -> tuple:
    """(whether the port agrees with Pillow on data, Pillow's result, the
    port's)."""
    a, b = pillow_rgb(data), port_rgb(data)
    if a[0] == "ok":
        same = (b[0] == "ok" and a[1].shape == b[1].shape
                and bool((a[1] == b[1]).all()))
    else:
        same = b[0] != "ok"
    return same, a, b


def _show(res: tuple) -> str:
    if res[0] == "ok":
        return f"ok {res[1].shape}"
    return " ".join(str(x) for x in res)[:120]


class _Count:
    def __init__(self, kind: str):
        self.kind, self.n, self.opened, self.bad = kind, 0, 0, 0

    def check(self, name: str, data: bytes) -> tuple:
        same, a, b = agree(data)
        self.n += 1
        self.opened += a[0] == "ok"
        if not same:
            self.bad += 1
            print(f"MISMATCH {self.kind} {name}: Pillow {_show(a)}; port "
                  f"{_show(b)}")
        return a, b

    def report(self) -> None:
        print(f"{self.kind}: {self.n} files, {self.opened} that Pillow "
              f"decodes, {self.bad} mismatches")


# ------------------------------------------------------------ the files

def _codestream(rng, h: int, w: int, mode: str) -> bytes:
    from PIL import Image as PILImage
    px = rng.integers(0, 256, (h, w, len(mode))).astype(np.uint8)
    im = PILImage.fromarray(px[..., 0] if mode == "L" else px, mode)
    f = io.BytesIO()
    im.save(f, "JPEG2000", no_jp2=True)
    return f.getvalue()


def lab_colr(size: int, fill: int = 0) -> bytes:
    """A colr box's body of CIELab (method 1, EnumCS 14) of size bytes:
    the 7 of the method, precedence, approximation and EnumCS, then
    parameters of the byte fill."""
    return (struct.pack(">BBBI", 1, 0, 0, 14) + bytes([fill]) * 32)[:size] \
        .ljust(size, bytes([fill]))


def colr_cases(rng):
    """A CIELab colr of each size 0-40 alone, then before each later colr
    (enumerated 16, 17, 18, ICC, methods 3 and 4), on RGB, grey and RGBA
    codestreams."""
    from jax_references import make_textures as mt
    streams = {m: _codestream(rng, 6, 9, m) for m in ("RGB", "L", "RGBA")}
    later = [None, (1, 16), (1, 17), (1, 18), (2, bytes(16)),
             struct.pack(">BBB", 3, 0, 0) + bytes(8),
             struct.pack(">BBB", 4, 0, 0)]
    for m, cs in streams.items():
        for size in range(0, 41):
            for nxt in later:
                colr = [lab_colr(size, size)] + ([] if nxt is None
                                                 else [nxt])
                yield (f"{m} lab{size} then {nxt!r:.20}",
                       mt.jp2_file(cs, colr=colr))


def jpx_cases(rng):
    """JPX files: the jpx brand with and without jp2 compatibility, rreq,
    jpch / jplh, cgrp, ftbl, dtbl, asoc, two codestreams; a file with jpch
    or jplh but no jp2h, an ftbl without jp2c, jpch boxes that carry colr,
    pclr or cdef, EnumCS 19-25 on 1, 3 and 4 components, colr method 5, a
    CIELab colr on 1 and 4 components."""
    from jax_references import make_textures as mt
    box = mt.box
    cs = {m: _codestream(rng, 6, 9, m) for m in ("RGB", "L", "RGBA")}
    rreq = box(b"rreq", bytes([1, 0x80, 0]) + struct.pack(">H", 0)
               + struct.pack(">H", 0))
    colr18 = box(b"colr", struct.pack(">BBBI", 1, 0, 0, 18))
    jpx = dict(brand=b"jpx ", compat=(b"jpx ", b"jp2 "))
    yield "jpx brand", mt.jp2_file(cs["RGB"], **jpx)
    yield "jpx only", mt.jp2_file(cs["RGB"], brand=b"jpx ",
                                  compat=(b"jpx ",))
    yield "rreq", mt.jp2_file(cs["RGB"], before=[rreq], **jpx)
    yield "jpch after", mt.jp2_file(cs["RGB"], after=[box(
        b"jpch", box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16)))], **jpx)
    yield "jplh before", mt.jp2_file(cs["RGB"], before=[box(
        b"jplh", box(b"cgrp", colr18))], **jpx)
    yield "cgrp inside", mt.jp2_file(cs["RGB"], inside=[box(
        b"cgrp", colr18)], **jpx)
    yield "asoc lbl xml", mt.jp2_file(cs["RGB"], after=[box(
        b"asoc", box(b"lbl ", b"name") + box(b"xml ", b"<a/>"))], **jpx)
    ftbl = box(b"ftbl", box(b"flst", struct.pack(">HHIIH", 1, 0, 0, 0, 0)))
    yield "ftbl and jp2c", mt.jp2_file(cs["RGB"], after=[ftbl], **jpx)
    yield "ftbl no jp2c", mt.jp2_file(cs["RGB"], after=[ftbl], jp2c=False,
                                      **jpx)
    yield "dtbl", mt.jp2_file(cs["RGB"], after=[box(
        b"dtbl", struct.pack(">H", 1) + box(b"url ", bytes(4) + b"a\0"))],
        **jpx)
    yield "two jp2c", mt.jp2_file(cs["RGB"], tail=[box(b"jp2c", cs["L"])],
                                  **jpx)
    for where in ("before", "after"):
        for kind in (b"jpch", b"jplh"):
            body = box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17))
            yield (f"{kind.decode()} {where}, no jp2h",
                   mt.jp2_file(cs["RGB"], jp2h=False,
                               **{where: [box(kind, body)]}, **jpx))
    for kind, body in (
            (b"colr", struct.pack(">BBBI", 1, 0, 0, 17)),
            (b"pclr", struct.pack(">HB", 2, 3) + bytes(3) + bytes(6)),
            (b"cdef", struct.pack(">HHHH", 1, 0, 0, 1))):
        for where in ("before", "after"):
            yield (f"jpch {where} with {kind.decode()}",
                   mt.jp2_file(cs["RGB"], **{where: [box(b"jpch", box(
                       kind, body))]}, **jpx))
    for m, n in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        for enumcs in range(19, 26):
            yield f"{m} enumcs {enumcs}", mt.jp2_file(
                cs[m], colr=((1, enumcs),), **jpx)
            yield f"{m} enumcs {enumcs} then sYCC", mt.jp2_file(
                cs[m], colr=((1, enumcs), (1, 18)), **jpx)
        yield f"{m} method 5", mt.jp2_file(cs[m], colr=(
            struct.pack(">BBB", 5, 0, 0) + bytes(12),), **jpx)
        yield f"{m} method 5 then sYCC", mt.jp2_file(cs[m], colr=(
            struct.pack(">BBB", 5, 0, 0) + bytes(12), (1, 18)), **jpx)
        for size in (7, 11, 35):
            yield f"{m} CIELab {size}", mt.jp2_file(
                cs[m], colr=(lab_colr(size),), **jpx)


def im_cases():
    """An IM file of type LAB (alone, after each type of Pillow's OPEN
    table, with and without a Lut of grey or of colour) of all 256 L
    values."""
    from cge_tpu_torch.scene import im
    from jax_references import make_textures as mt
    body = np.arange(256, dtype=np.uint8).tobytes()
    rng = np.random.default_rng(7)
    luts = (None, np.tile(np.arange(256, dtype=np.uint8), 3).tobytes(),
            rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    for k, lut in enumerate(luts):
        for first in [None] + sorted(im.OPEN):
            kind = b"LAB" if first is None else (
                first.encode() + b"\r\nImage type: LAB")
            raw = "L" if first is None else im.OPEN[first][1]
            n = mt.im_body_size(raw, 16, 16)
            yield (f"LAB after {first} lut {k}",
                   mt.im_file(kind, 16, 16, (body * 20)[:n], lut=lut))


# the formats Pillow writes, and the modes each writes of one band or the
# ones that refuse
NESTED = {
    "PNG": ("1", "L", "P", "I;16", "I", "RGB", "LA"),
    "BMP": ("1", "L", "P", "RGB"),
    "GIF": ("L", "P"),
    "JPEG": ("L", "RGB", "CMYK"),
    "PPM": ("1", "L", "I", "F", "RGB"),
    "TIFF": ("1", "L", "P", "I;16", "I;16B", "I", "F", "RGB", "LA"),
    "TGA": ("L", "P", "RGB"),
    "SGI": ("L", "RGB"),
    "PCX": ("1", "L", "P", "RGB"),
    "DDS": ("L", "P", "RGB", "LA"),
    "JPEG2000": ("L", "I;16", "RGB"),
    "ICO": ("1", "L", "P", "RGB"),
    "IM": ("1", "L", "P", "I", "F", "I;16", "I;16L", "I;16B", "RGB", "LA",
           "PA", "CMYK", "YCbCr", "LAB"),
    "MSP": ("1",),
    "QOI": ("RGB",),
    "SPIDER": ("F",),
    "WEBP": ("RGB",),
    "XBM": ("1",),
    "BLP": ("P", "RGB"),
}


def nested_image(rng, fmt: str, mode: str, w: int = 4, h: int = 3):
    """A w x h image of mode saved by Pillow as fmt, or None where Pillow
    cannot write it."""
    import warnings

    from PIL import Image as PILImage
    if mode.startswith("I;16"):
        im = PILImage.fromarray(rng.integers(0, 65536, (h, w))
                                .astype(np.uint16))
    elif mode == "I":
        im = PILImage.fromarray(rng.integers(-5, 70000, (h, w))
                                .astype(np.int32))
    elif mode == "F":
        im = PILImage.fromarray(rng.uniform(-5, 300, (h, w))
                                .astype(np.float32))
    elif mode == "P":
        im = PILImage.fromarray(rng.integers(0, 7, (h, w)).astype(np.uint8))
        im = im.convert("P")
        im.putpalette(rng.integers(0, 256, 21).astype(np.uint8).tobytes())
    elif mode == "LAB":
        im = PILImage.frombytes("LAB", (w, h), rng.integers(
            0, 256, 3 * w * h).astype(np.uint8).tobytes())
    else:
        im = PILImage.fromarray(rng.integers(0, 256, (h, w, 4))
                                .astype(np.uint8)).convert(mode)
    f = io.BytesIO()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if mode in ("I;16L", "I;16B"):
                im = im.convert(mode)
            im.save(f, fmt)
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return f.getvalue()


def iptc_cases(rng):
    """RGB (and CMYK) IPTC streams whose JPEG-compressed data (compression
    5: Pillow opens the bytes whatever they are) is a file of each format
    and mode of NESTED, in each band."""
    from jax_references import make_textures as mt
    for fmt, mode_list in NESTED.items():
        for mode in mode_list:
            side = 16 if fmt == "ICO" else 4
            data = nested_image(rng, fmt, mode, side, 3 if side == 4 else 16)
            if data is None:
                continue
            for layers, band in ((3, 0), (3, 1), (3, 2), (1, None),
                                 (4, 0), (4, 3)):
                yield (f"{fmt} {mode} layers {layers} band {band}",
                       mt.iptc_file(data, side, 3, layers=layers,
                                    component=0 if layers == 1 else 1,
                                    compression=5, band=band))


def iptc_fixture_cases():
    """Every texture fixture of the tests (under 200 KB), each format the
    port reads in every mode its fixtures hold, as the nested image of an L
    stream and of bands 0 and 1 of an RGB one."""
    from jax_references import make_textures as mt
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "torch_textures")
    for folder, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            path = os.path.join(folder, name)
            if name == "manifest.json" or os.path.getsize(path) > 200_000:
                continue
            with open(path, "rb") as f:
                data = f.read()
            for layers, band in ((1, None), (3, 0), (3, 1)):
                yield (f"{name} layers {layers} band {band}",
                       mt.iptc_file(data, 4, 3, layers=layers,
                                    component=0 if layers == 1 else 1,
                                    compression=5, band=band))


def ojpeg_cases(rng, n: int = 1000):
    """Planar old-style JPEG TIFFs of one or several striles a plane
    (strips or tiles, each form of make_textures.ojpeg_tiff, striles of up
    to a few KB) whose plane 1 (or 2) SOS is corrupt (its length, its
    count, its component, a byte of it at random), missing (with plane 2's
    too), or cut with the file: where plane 1's search fails, plane 0's
    libjpeg session, which libtiff does not restart, reads its later
    striles from where that search stopped."""
    from jax_references import make_textures as mt
    for i in range(n):
        h = int(rng.choice([16, 24, 32, 48]))
        w = int(rng.choice([16, 24, 40, 64, 200, 640]))
        px = mt.smooth_image(rng, h, w, float(rng.choice([5.0, 25.0, 80.0])))
        if rng.random() < 0.3:
            px = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        kw = dict(planar=2, sampling=((1, 1),) * 3,
                  form=str(rng.choice(["jif", "stream", "tables"])),
                  quality=int(rng.choice([50, 85, 95])))
        if rng.random() < 0.3:
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16)
            if kw["form"] == "stream":
                kw["form"] = "jif"
        else:
            kw["rows_per_strip"] = 8 * int(rng.integers(1, h // 8 + 1))
        if kw["form"] == "tables":
            kw["subsampling_tag"] = (1, 1)
        try:
            data = mt.ojpeg_tiff(px, 6, **kw)
        except ValueError:
            continue
        b = bytearray(data)
        starts = [j for j in range(len(b) - 1) if b[j] == 0xFF
                  and b[j + 1] == 0xDA]
        if len(starts) < 2:
            continue
        at = starts[1 if rng.random() < 0.8 or len(starts) < 3 else 2]
        kind = str(rng.choice(["len", "count", "cid", "flip", "missing",
                               "both", "cut"]))
        if kind == "len":
            b[at + 3] ^= int(rng.integers(1, 256))
        elif kind == "count":
            b[at + 4] = int(rng.choice([0, 2, 3]))
        elif kind == "cid":
            b[at + 5] = int(rng.integers(4, 256))
        elif kind == "flip":
            b[at + int(rng.integers(2, 10))] = int(rng.integers(0, 256))
        elif kind == "missing":
            b[at + 1] = 0
        elif kind == "both":
            for j in starts[1:]:
                b[j + 1] = 0
        else:
            b = b[:at + int(rng.integers(2, 8))] + bytes(len(b) - at - 8)
            b = b[:len(data)]
        yield f"{i} {kind} {kw}", bytes(b)


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        _serve()
        return 0
    kinds = argv or ["colr", "jpx", "im", "iptc", "iptc_fixtures", "ojpeg"]
    rng = np.random.default_rng(30)
    cases = {"colr": lambda: colr_cases(rng), "jpx": lambda: jpx_cases(rng),
             "im": im_cases, "iptc": lambda: iptc_cases(rng),
             "iptc_fixtures": iptc_fixture_cases,
             "ojpeg": lambda: ojpeg_cases(rng)}
    bad = 0
    for kind in kinds:
        count = _Count(kind)
        for name, data in cases[kind]():
            count.check(name, data)
        count.report()
        bad += count.bad
    _WORKER.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
