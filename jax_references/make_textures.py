"""Makes the texture fixtures of the port's image decoders
(tests/torch_textures/): small files of every kind that the port's
`load_image` reads (PNG at every bit depth and colour type, plain and
Adam7 interlaced; BMP of every depth, header and compression it reads;
baseline and progressive JPEG in grey, 4:4:4, 4:2:2 and 4:2:0, with and
without restart intervals, JFIF YCbCr and Adobe RGB / YCbCr), and one
1024x1024 progressive 4:2:0 JPEG at quality 90, all from seeded numpy
images. It is the JAX side: Pillow writes the JPEGs, the encoders below
write the PNGs (with the port's row filters) and BMPs, and the JAX
package's `cge_tpu.scene.image_io.load_image` (Pillow's
`convert("RGB")`) gives the reference pixels.

manifest.json records each file's kind, format, shape and the SHA-256 of
JAX's pixels quantised to u8 ([H, W, 3] C order), with the Pillow and
libjpeg-turbo versions, the commit and the command. The port's tests hold
its decoders to JAX's pixels on every file; chip_smoke.py holds them to
the manifest's hashes on the card's machine, which has no Pillow.

    JAX_PLATFORMS=cpu python3 jax_references/make_textures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402
from PIL import features  # noqa: E402

from cge_tpu_torch.scene.image_io import _chunk, _filter_rows  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_textures")
MANIFEST = os.path.join(OUT, "manifest.json")
BIG = "jpeg_progressive_420_q90_1024.jpg"
COMMAND = "JAX_PLATFORMS=cpu python3 jax_references/make_textures.py"

# ---------------------------------------------------------------- PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] -> scanline bytes [h, stride] (no filter byte)."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint32)], axis=1)
    groups = flat.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1, dtype=np.uint32)
    return (groups << shifts).sum(-1).astype(np.uint8)


def png_file(samples: np.ndarray, depth: int, ctype: int,
             interlace: bool = False, palette=None, trns: bytes = b"",
             filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of any bit depth and colour type: samples [h, w, ch] integers
    (palette indices for colour type 3, with palette [K, 3]), plain or
    Adam7, rows filtered in turn by `filters`, with an optional tRNS."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    assert ch == _CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)
    if interlace:
        body = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                body += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    else:
        body = _filter_rows(_pack_rows(samples, depth), bpp, filters)
    parts = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns:
        parts.append(_chunk(b"tRNS", trns))
    body = zlib.compress(body, 9)
    parts += [_chunk(b"IDAT", body[:len(body) // 2]),
              _chunk(b"IDAT", body[len(body) // 2:]), _chunk(b"IEND", b"")]
    return b"".join(parts)


# ---------------------------------------------------------------- BMP

def _rows(data_rows, row_bytes: int) -> bytes:
    stride = (row_bytes + 3) & ~3
    return b"".join(bytes(r) + bytes(stride - len(bytes(r)))
                    for r in data_rows)


def bmp_file(width: int, height: int, bits: int, pixel_data: bytes,
             compression: int = 0, header: int = 40, masks=None,
             palette=None, top_down: bool = False) -> bytes:
    """A BMP around its pixel data (rows in file order): header of 12,
    40, 108 or 124 bytes; masks after a 40-byte header or inside a
    larger one; palette [K, 3] RGB written as BGR(X)."""
    pal = b""
    if palette is not None:
        pad = b"" if header == 12 else b"\x00"
        pal = b"".join(bytes((int(c[2]), int(c[1]), int(c[0]))) + pad
                       for c in palette)
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixel_data), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        m = tuple(masks or (0, 0, 0)) + (0,)
        if header == 40:
            extra = struct.pack("<III", *m[:3]) if masks else b""
        else:
            info += struct.pack("<IIII", *m[:4]) + bytes(header - 56)
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixel_data), 0, 0,
                                offset) + info + extra + pal + pixel_data)


def rle_stream(idx: np.ndarray, rle4: bool, rng) -> bytes:
    """Palette indices [h, w] (bottom row first) as an RLE8 / RLE4 stream
    of encoded runs, absolute runs and end-of-line codes, ended by end of
    bitmap; absolute runs are padded to an even length, as the format
    asks (even runs only under RLE4, which Pillow reads whole)."""
    out = bytearray()
    for row in idx:
        x, w = 0, len(row)
        while x < w:
            n = int(min(w - x, rng.integers(1, 9)))
            run = row[x:x + n]
            if rng.random() < 0.5 or n < 3 or (rle4 and n % 2):
                # an encoded run of the first index (RLE4: of the first two
                # in turn)
                second = int(run[1]) if rle4 and n > 1 else 0
                out += bytes((n, (int(run[0]) << 4 | second) if rle4
                              else int(run[0])))
            else:
                out += bytes((0, n))
                if rle4:
                    body = bytes((int(run[i]) << 4) | int(run[i + 1])
                                 for i in range(0, n, 2))
                else:
                    body = bytes(int(v) for v in run)
                out += body + bytes(len(body) % 2)
            x += n
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


# ---------------------------------------------------------------- images

def smooth_image(rng, h: int, w: int, noise: float) -> np.ndarray:
    """A seeded sum of sinusoids with Gaussian noise, [h, w, 3] u8."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w, 3), 127.0)
    for _ in range(6):
        fx, fy = rng.uniform(-0.08, 0.08, 2)
        amp = rng.uniform(10, 30, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        img += amp * np.sin(fx * x[..., None] + fy * y[..., None] + ph)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _pillow(im, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def adobe_transform_1(jfif_jpeg: bytes) -> bytes:
    """A JFIF YCbCr JPEG with its APP0 replaced by an Adobe APP14 marker
    of transform 1 (YCbCr)."""
    assert jfif_jpeg[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", jfif_jpeg[4:6])[0]
    app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes(
        (0, 100, 0, 0, 0, 0, 1))
    return jfif_jpeg[:2] + app14 + jfif_jpeg[4 + n:]


def fixtures() -> dict:
    """name -> (kind, file bytes), every fixture made from seed 16."""
    rng = np.random.default_rng(16)
    out = {}
    h, w = 13, 11                                 # odd, Adam7 passes uneven
    names = {0: "grey", 2: "rgb", 3: "palette", 4: "grey_alpha", 6: "rgba"}
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
    for ctype, ds in depths.items():
        for depth in ds:
            for interlace in (False, True):
                ch = _CHANNELS[ctype]
                top = 1 << depth
                px = rng.integers(0, top, (h, w, ch))
                if depth == 16 and ctype == 0:
                    # around and past 255: Pillow saturates 16-bit grey
                    px = rng.choice([0, 7, 200, 255, 256, 1000, 65535],
                                    (h, w, 1))
                palette, trns = None, b""
                if ctype == 3:
                    k = min(top, 6) if depth == 8 else top
                    palette = rng.integers(0, 256, (k, 3))
                    if depth == 8:   # indices past the palette: black
                        px = rng.integers(0, 10, (h, w, 1))
                    trns = bytes((0, 128))
                elif ctype == 0 and depth == 8:
                    trns = struct.pack(">H", 7)
                name = (f"png_{names[ctype]}_{depth}bit"
                        f"{'_adam7' if interlace else ''}.png")
                out[name] = ("png", png_file(px, depth, ctype, interlace,
                                             palette, trns))
    # BMP
    bh, bw = 9, 13
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (200, 3))
    idx1 = rng.integers(0, 2, (bh, bw))
    idx4 = rng.integers(0, 16, (bh, bw))
    idx8 = rng.integers(0, 256, (bh, bw))         # past 200 entries: black

    def nibbles(idx):
        return [bytes((int(r[i]) << 4) | (int(r[i + 1]) if i + 1 < bw else 0)
                      for i in range(0, bw, 2)) for r in idx]

    out["bmp_1bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 1, _rows([np.packbits(r.astype(np.uint8)).tobytes()
                          for r in idx1], (bw + 7) // 8),
        palette=pal16[:2]))
    out["bmp_1bit_core.bmp"] = ("bmp", bmp_file(
        bw, bh, 1, _rows([np.packbits(r.astype(np.uint8)).tobytes()
                          for r in idx1], (bw + 7) // 8),
        header=12, palette=pal16[:2]))
    out["bmp_4bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, _rows(nibbles(idx4), (bw + 1) // 2), palette=pal16))
    out["bmp_4bit_v5_top_down.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, _rows(nibbles(idx4), (bw + 1) // 2), header=124,
        palette=pal16, top_down=True))
    out["bmp_8bit.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, _rows([r.astype(np.uint8).tobytes() for r in idx8], bw),
        palette=pal256))
    grey = np.stack([np.arange(256)] * 3, axis=1)
    out["bmp_8bit_grey.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, _rows([r.astype(np.uint8).tobytes() for r in idx8], bw),
        palette=grey))
    out["bmp_8bit_rle8.bmp"] = ("bmp", bmp_file(
        bw, bh, 8, rle_stream(idx8, False, rng), compression=1,
        palette=pal256))
    out["bmp_4bit_rle4.bmp"] = ("bmp", bmp_file(
        bw, bh, 4, rle_stream(idx4, True, rng), compression=2,
        palette=pal16))
    # delta and a short row: hand-made (Pillow reads a delta's two
    # offsets after two other bytes)
    delta = bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 0, 0, 2, 9, 9, 1, 1, 4, 7,
                   0, 0, 2, 8, 0, 0, 8, 1, 0, 1])
    out["bmp_8bit_rle8_delta.bmp"] = ("bmp", bmp_file(
        8, 4, 8, delta, compression=1, palette=pal256))
    delta4 = bytes([3, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 0, 0, 0, 2, 9, 9,
                    1, 1, 4, 0x77, 0, 0, 2, 8, 0, 0, 8, 1, 0, 1])
    out["bmp_4bit_rle4_delta.bmp"] = ("bmp", bmp_file(
        8, 4, 4, delta4, compression=2, palette=pal16))
    v16 = rng.integers(0, 65536, (bh, bw)).astype("<u2")
    d16 = _rows([r.tobytes() for r in v16], 2 * bw)
    out["bmp_16bit_555.bmp"] = ("bmp", bmp_file(bw, bh, 16, d16))
    out["bmp_16bit_565_bitfields.bmp"] = ("bmp", bmp_file(
        bw, bh, 16, d16, compression=3, masks=(0xF800, 0x7E0, 0x1F)))
    out["bmp_16bit_555_bitfields_v4.bmp"] = ("bmp", bmp_file(
        bw, bh, 16, d16, compression=3, header=108,
        masks=(0x7C00, 0x3E0, 0x1F)))
    v24 = rng.integers(0, 256, (bh, 3 * bw)).astype(np.uint8)
    d24 = _rows([r.tobytes() for r in v24], 3 * bw)
    out["bmp_24bit.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24))
    out["bmp_24bit_top_down.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24,
                                                     top_down=True))
    out["bmp_24bit_core.bmp"] = ("bmp", bmp_file(bw, bh, 24, d24,
                                                 header=12))
    v32 = rng.integers(0, 2 ** 32, (bh, bw), dtype=np.uint64).astype("<u4")
    d32 = _rows([r.tobytes() for r in v32], 4 * bw)
    out["bmp_32bit.bmp"] = ("bmp", bmp_file(bw, bh, 32, d32))
    out["bmp_32bit_bitfields.bmp"] = ("bmp", bmp_file(
        bw, bh, 32, d32, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00)))
    out["bmp_32bit_bitfields_v5.bmp"] = ("bmp", bmp_file(
        bw, bh, 32, d32, compression=3, header=124,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    # JPEG
    jh, jw = 37, 29                                # not whole MCUs
    im = PILImage.fromarray(smooth_image(rng, jh, jw, 12.0))
    for prog in (False, True):
        mode = "progressive" if prog else "baseline"
        for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
            out[f"jpeg_{mode}_{tag}.jpg"] = ("jpeg", _pillow(
                im, "JPEG", quality=85, subsampling=sub, progressive=prog))
        out[f"jpeg_{mode}_grey.jpg"] = ("jpeg", _pillow(
            im.convert("L"), "JPEG", quality=85, progressive=prog))
        out[f"jpeg_{mode}_adobe_rgb.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, progressive=prog, keep_rgb=True))
        out[f"jpeg_{mode}_420_restart.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, subsampling=2, progressive=prog,
            restart_marker_blocks=3))
        out[f"jpeg_{mode}_422_restart_rows.jpg"] = ("jpeg", _pillow(
            im, "JPEG", quality=85, subsampling=1, progressive=prog,
            restart_marker_rows=1))
        out[f"jpeg_{mode}_adobe_ycc.jpg"] = ("jpeg", adobe_transform_1(
            _pillow(im, "JPEG", quality=85, subsampling=2,
                    progressive=prog)))
    small = PILImage.fromarray(smooth_image(rng, 3, 5, 12.0))
    for sub, tag in ((1, "422"), (2, "420")):
        out[f"jpeg_baseline_{tag}_tiny.jpg"] = ("jpeg", _pillow(
            small, "JPEG", quality=90, subsampling=sub))
    big = PILImage.fromarray(smooth_image(rng, 1024, 1024, 4.0))
    out[BIG] = ("jpeg", _pillow(big, "JPEG", quality=90, subsampling=2,
                                progressive=True))
    return out


def jax_pixels(path: str) -> np.ndarray:
    """cge_tpu's load_image of the file, quantised to u8 [H, W, 3]."""
    from cge_tpu.scene.image_io import load_image

    return np.rint(load_image(path).pixels * 255.0).astype(np.uint8)


def sha256(u8: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(u8, np.uint8)
                          .tobytes()).hexdigest()


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    files = []
    for name, (kind, data) in fixtures().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        u8 = jax_pixels(path)
        files.append(dict(name=name, kind=kind, bytes=len(data),
                          shape=list(u8.shape), sha256=sha256(u8)))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    meta = dict(pillow=PILImage.__version__,
                libjpeg_turbo=features.version("libjpeg_turbo"),
                commit=commit, command=COMMAND, seed=16, files=files)
    with open(MANIFEST, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    total = sum(x["bytes"] for x in files)
    print(f"{len(files)} fixtures, {total} bytes, in "
          f"{os.path.relpath(OUT, REPO)} ({BIG}: "
          f"{next(x['bytes'] for x in files if x['name'] == BIG)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
