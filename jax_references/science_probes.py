"""Probes of the Pillow 12 plugins the port's science formats follow (FITS,
McIdas, SPIDER, IM, IM Tools, IPTC/NAA), whose unpackers and bit decoder
(Unpack.c, BitDecode.c, Convert.c) are only compiled into Pillow's
_imaging: the port's image_io.decode_image against Pillow's
Image.open(path).convert("RGB") on seeded files of each format, well
formed, with odd headers, and cut or byte-flipped: the same pixels, or
both refusing (a file with a NaN sample, whose 8 bits Pillow's cast
leaves undefined and the port refuses, is counted apart).

    JAX_PLATFORMS=cpu python3 jax_references/science_probes.py [N] [kind]

N files a format (default 2000); kind limits the run to one of fits,
mcidas, spider, im, imt, iptc. It prints each mismatch and the counts.
"""

from __future__ import annotations

import io
import os
import sys
import tempfile
import warnings

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402

from cge_tpu_torch.scene import im, image_io  # noqa: E402
from jax_references import make_textures as mt  # noqa: E402

def _body(rng, n: int, floats: bool = False) -> bytes:
    """n bytes: random, or of small values, or float32 samples."""
    r = rng.random()
    if floats and r < 0.5:
        v = rng.choice([rng.uniform(-20, 300, n // 4 + 1),
                        rng.integers(0, 256, n // 4 + 1).astype(float)])
        return v.astype(rng.choice(["<f4", ">f4"])).tobytes()[:n]
    if r < 0.75:
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    return rng.integers(0, 4, n).astype(np.uint8).tobytes()


def _lut(rng) -> bytes:
    kind = rng.integers(0, 4)
    ramp = np.arange(256, dtype=np.uint8)
    if kind == 0:
        return np.tile(ramp, 3).tobytes()
    if kind == 1:
        return np.tile(ramp[::-1], 3).tobytes()
    lut = rng.integers(0, 256, 768).astype(np.uint8)
    if kind == 3:
        return lut.tobytes()[:int(rng.integers(300, 768))]
    return lut.tobytes()


# bare mode names as image types (outside OPEN): Pillow takes the name as
# the mode, with the layout an earlier type line left (LAB, which Pillow
# reads from L through its own Lab conversion, is not ported)
BARE = ["1", "L", "LA", "P", "PA", "I", "F", "RGB", "RGBA", "RGBX", "CMYK",
        "YCbCr", "I;16", "I;16B", "foo", ""]


def im_case(rng) -> bytes:
    kind = str(rng.choice(sorted(im.OPEN) + BARE))
    raw = im.OPEN.get(kind, ("L", "L"))[1]
    if kind in BARE and rng.random() < 0.7:
        first = str(rng.choice(sorted(im.OPEN)))
        raw = im.OPEN[first][1]
        kind = first.encode() + b"\r\nImage type: " + kind.encode()
        kind = kind.decode()
    w, h = (int(v) for v in rng.integers(1, 9, 2))
    n = mt.im_body_size(raw, w, h)
    body = _body(rng, n + int(rng.integers(0, 4)), raw.startswith("F;3"))
    lines, size = [], None
    if rng.random() < 0.15:
        size = bytes(rng.choice([b"%d,%d" % (w, h), b"%d" % w,
                                 b"%d*%d*1" % (w, h), b"%d.0*%d" % (w, h),
                                 b"abc", b"0*%d" % h, b" %d *%d" % (w, h),
                                 b"-%d*%d" % (w, h), b"%d*" % w,
                                 b"99999*99999"]))
    if rng.random() < 0.2:
        lines.append(bytes(rng.choice([b"Name: x.im", b"Comment: hi",
                                       b"File size (no of images): 2",
                                       b"Scale (x,y): 1.5", b"Bogus: 1",
                                       b"no colon here", b"Date: today"])))
    lut = _lut(rng) if rng.random() < 0.25 else None
    return mt.im_file(kind.encode(), w, h, body, lut=lut, lines=lines,
                      eol=bytes(rng.choice([b"\r\n", b"\n", b"\n\r"])),
                      pad=rng.random() < 0.7, size=size)


def imt_case(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 9, 2))
    lines = [b"width %d" % w, b"height %d" % h, b"pixel n8"]
    extra = [b"* a comment", b"name x", b"width abc", b"pixel n16",
             b"Bad line", b"height", b"", b"x" * 120, b"width 0"]
    for _ in range(int(rng.integers(0, 3))):
        lines.insert(int(rng.integers(0, len(lines) + 1)),
                     bytes(rng.choice(extra)))
    if rng.random() < 0.2:
        lines.pop(int(rng.integers(0, len(lines))))
    return mt.imt_file(w, h, _body(rng, w * h + int(rng.integers(0, 3))),
                       lines)


def fits_case(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 7, 2))
    if rng.random() < 0.3:
        zbits = int(rng.choice([8, 16, 32, -32, 12]))
        n = 4 * w * h - (int(rng.integers(0, 4)) if rng.random() < 0.2
                         else 0)
        return mt.fits_gzip_file(_body(rng, n), w, h, zbits,
                                 member=rng.random() < 0.9)
    bitpix = int(rng.choice([8, 16, 32, -32, -64, 12, 64]))
    px = rng.integers(0, 300, (h, w))
    if bitpix < 0 and rng.random() < 0.3:
        px = rng.uniform(-2, 300, (h, w))
        if rng.random() < 0.2:
            px[0, 0] = np.nan
    cards = []
    if rng.random() < 0.2:
        cards.append(mt.fits_card(b"BZERO", b"32768"))
    naxis = None
    r = rng.random()
    if r < 0.1:
        naxis = [mt.fits_card(b"NAXIS", b"1"), mt.fits_card(b"NAXIS1",
                                                           b"%d" % (w * h))]
        px = px.reshape(w * h, 1)
    elif r < 0.15:
        naxis = [mt.fits_card(b"NAXIS", b"2"), mt.fits_card(b"NAXIS1",
                                                           b"%d" % w)]
    elif r < 0.2:
        naxis = [mt.fits_card(b"NAXIS", b"0")]
    elif r < 0.25:
        naxis = [mt.fits_card(b"NAXIS", b"2.0")]
    data = mt.fits_file(px if bitpix in mt.FITS_TYPES else px.astype(
        np.uint8), bitpix if bitpix in mt.FITS_TYPES else 8,
        cards=cards, pad=rng.random() < 0.7, naxis=naxis)
    if bitpix not in mt.FITS_TYPES:
        data = data.replace(mt.fits_card(b"BITPIX", b"8"),
                            mt.fits_card(b"BITPIX", b"%d" % bitpix), 1)
    return data


def mcidas_case(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 7, 2))
    nbytes = int(rng.choice([1, 2, 4, 3]))
    px = rng.integers(0, 400, (h, w, int(rng.integers(1, 3))))
    words = {}
    if rng.random() < 0.3:
        words[14] = int(rng.integers(-2, 3))
    if rng.random() < 0.1:
        words[15] = int(rng.integers(-3, 3))
    data = mt.mcidas_file(px, nbytes if nbytes != 3 else 1,
                          int(rng.integers(0, 4)),
                          int(rng.choice([256, 300, 100])), words,
                          bytes(int(rng.integers(0, 3))))
    if nbytes == 3:
        data = data[:43] + b"\x03" + data[44:]
    return data


def spider_case(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 9, 2))
    px = rng.uniform(-10, 300, (h, w))
    if rng.random() < 0.1:
        px[0, 0] = np.nan
    kw = {}
    r = rng.random()
    if r < 0.15:
        kw.update(istack=float(rng.integers(1, 3)), maxim=1.0)
    elif r < 0.2:
        kw.update(imgnumber=1.0)
    elif r < 0.25:
        kw.update(istack=-1.0)
    elif r < 0.3:
        kw.update(iform=float(rng.choice([3, -11, 2])))
    elif r < 0.35:
        kw.update(istack=float("nan"))
    data = mt.spider_file(px, big=rng.random() < 0.5, **kw)
    if kw.get("istack", 0) > 0:
        data = data[:len(data) - 4 * w * h] + mt.spider_file(px)
    return data


def iptc_case(rng) -> bytes:
    w, h = (int(v) for v in rng.integers(1, 9, 2))
    layers, comp = [(1, 0), (3, 1), (4, 1), (3, 0), (2, 1)][
        int(rng.integers(0, 5))]
    band = int(rng.integers(-1, layers + 1)) if rng.random() < 0.5 else None
    if rng.random() < 0.6:
        compression = 1
        payload = _body(rng, max(0, w * h + int(rng.integers(-2, 3))))
    else:
        compression = 5
        grey = rng.random() < 0.6
        px = rng.integers(0, 256, (h, w) if grey else (h, w, 3)).astype(
            np.uint8)
        b = io.BytesIO()
        PILImage.fromarray(px).save(b, "JPEG", quality=90)
        payload = b.getvalue()
    if rng.random() < 0.1:
        compression = int(rng.choice([0, 2]))
    fields = []
    if rng.random() < 0.2:
        fields.append(mt.iptc_field(2, 5, b"a title"))
    tail = bytes(rng.choice([b"", b"", b"\0" * 5, b"\x1c\x02\x05\x00\x01x",
                             b"junk!"]))
    return mt.iptc_file(payload, w, h, layers, comp, compression, band,
                        chunk=int(rng.choice([8000, 7, 40000])),
                        fields=fields, tail=tail)


CASES = {"fits": fits_case, "mcidas": mcidas_case, "spider": spider_case,
         "im": im_case, "imt": imt_case, "iptc": iptc_case}


def damaged(rng, data: bytes) -> bytes:
    """data cut short, or with a few bytes flipped, or whole."""
    r = rng.random()
    if r < 0.3 and len(data) > 1:
        return data[:int(rng.integers(1, len(data)))]
    if r < 0.6:
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        return bytes(b)
    return data


def pillow(path: str):
    """JAX's loader's pixels ([H, W, 3] u8), or None where it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with PILImage.open(path) as img:
                return np.asarray(img.convert("RGB"))
    except Exception:
        return None


def port(data: bytes):
    """The port's pixels, None where it refuses, "nan" where it refuses a
    NaN sample (whose 8 bits Pillow's cast leaves undefined)."""
    try:
        return image_io.decode_image(data)
    except ValueError as e:
        return "nan" if "NaN sample" in str(e) else None


def main(argv) -> int:
    n = int(argv[0]) if argv else 2000
    kinds = argv[1:] or sorted(CASES)
    rng = np.random.default_rng(28)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe")
        for kind in kinds:
            met = decoded = nans = 0
            for i in range(n):
                data = CASES[kind](rng)
                if i % 2:
                    data = damaged(rng, data)
                with open(path, "wb") as f:
                    f.write(data)
                want, got = pillow(path), port(data)
                if isinstance(got, str):
                    nans += 1
                    continue
                same = (want is None and got is None) or (
                    want is not None and got is not None
                    and want.shape == got.shape and (want == got).all())
                if not same:
                    bad += 1
                    print(f"MISMATCH {kind} #{i}: Pillow "
                          f"{None if want is None else want.shape}, port "
                          f"{None if got is None else got.shape}; "
                          f"{data[:60]!r}")
                met += same
                decoded += want is not None
            print(f"{kind}: {met} of {n - nans} met ({decoded} decoded by "
                  f"Pillow; {nans} more held a NaN sample, which the port "
                  f"refuses)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
