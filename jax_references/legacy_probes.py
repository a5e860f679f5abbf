"""Probes of the Pillow 12 decoders the port's legacy formats follow, whose
C sources are not at hand (FliDecode.c, PcdDecode.c and the "YCC;P"
unpacker are compiled into Pillow's _imaging): the port against Pillow
directly, on files made here.

  --fli N   N seeded FLC files of random sub-chunks (BRUN, COPY, LC, SS2,
            BLACK, palettes, stamps and unknown types), half of them up to
            400 pixels wide, their sizes, counts and bytes damaged and
            their ends cut: the port's image_io.decode_image against
            Pillow's Image.open(...).convert("RGB"), the same pixels or
            both refusing.
  --pcd     Pillow's PhotoYCC conversion on all 2^24 (Y, C1, C2) triples,
            in 43 PCD files, against the port's.

    JAX_PLATFORMS=cpu python3 jax_references/legacy_probes.py --fli 20000 --pcd
"""

from __future__ import annotations

import io
import os
import sys
import warnings

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
from PIL import Image as PILImage  # noqa: E402

from cge_tpu_torch.scene import image_io  # noqa: E402
from jax_references import make_textures as mt  # noqa: E402


def _sub_chunk(rng, w: int, h: int) -> bytes:
    kind = int(rng.choice([4, 11, 7, 12, 13, 15, 16, 18, 99]))
    prev = rng.integers(0, 256, (h, w)).astype(np.uint8)
    new = prev.copy()
    new[rng.random((h, w)) < 0.4] = rng.integers(0, 256)
    body = {4: lambda: mt.fli_colors([(int(rng.integers(0, 9)), rng.integers(
                0, 256, (int(rng.integers(1, 9)), 3)))]),
            11: lambda: mt.fli_colors([(0, rng.integers(0, 64, (3, 3)) << 2)],
                                      2),
            7: lambda: mt.fli_ss2(prev, new), 12: lambda: mt.fli_lc(prev, new),
            13: lambda: b"", 15: lambda: mt.fli_brun(new),
            16: lambda: new.tobytes(), 18: lambda: bytes(7),
            99: lambda: bytes(int(rng.integers(0, 8)))}[kind]()
    size = None
    if rng.random() < 0.1:
        size = int(rng.integers(0, 6 + len(body) + 8))
    if rng.random() < 0.15 and body:
        body = body[:int(rng.integers(0, len(body)))]
    return mt.fli_chunk(kind, body, size)


def random_fli(rng) -> bytes:
    """A seeded FLC of one frame of random, damaged sub-chunks."""
    wide = rng.random() < 0.5
    w = int(rng.integers(100, 400) if wide else rng.integers(1, 12))
    h = int(rng.integers(1, 4) if wide else rng.integers(1, 9))
    chunks = [_sub_chunk(rng, w, h) for _ in range(int(rng.integers(0, 5)))]
    size = int(rng.integers(0, 40)) if rng.random() < 0.1 else None
    count = int(rng.integers(0, 7)) if rng.random() < 0.1 else None
    data = bytearray(mt.fli_header(w, h) + mt.fli_frame(chunks, size, count))
    if rng.random() < 0.2:
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(128, len(data)))] = int(rng.integers(0, 256))
    if rng.random() < 0.1:
        data = data[:int(rng.integers(130, len(data) + 1))]
    if rng.random() < 0.1:
        data += bytes(rng.integers(0, 256, int(rng.integers(1, 20)),
                                   np.uint8))
    return bytes(data)


def _pillow(data: bytes):
    try:
        with PILImage.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


def _port(data: bytes):
    try:
        return image_io.decode_image(data)
    except ValueError:
        return None


def probe_fli(n: int, seed: int = 27) -> tuple:
    """(files, decoded by Pillow, differing) over n seeded files."""
    rng = np.random.default_rng(seed)
    decoded = differ = 0
    for _ in range(n):
        data = random_fli(rng)
        a, b = _pillow(data), _port(data)
        decoded += a is not None
        if (a is None) != (b is None) or (a is not None
                                          and not np.array_equal(a, b)):
            differ += 1
    return n, decoded, differ


def probe_pcd() -> tuple:
    """(triples covered, pixels differing) over all 2^24 triples."""
    per = 256 * 384
    seen = np.zeros(1 << 24, bool)
    differ = 0
    for part in range(43):
        s = np.arange(part * per, (part + 1) * per) % (65536 * 64)
        pair, j = s // 64, s % 64
        c1 = (pair // 256).astype(np.uint8).reshape(256, 384)
        c2 = (pair % 256).astype(np.uint8).reshape(256, 384)
        y = (4 * j[:, None] + np.arange(4)).astype(np.uint8).reshape(
            256, 384, 2, 2).transpose(0, 2, 1, 3).reshape(512, 768)
        data = mt.pcd_file(y, c1, c2)
        a, b = _pillow(data), _port(data)
        differ += int((a != b).any(-1).sum())
        big = [np.repeat(np.repeat(c, 2, 0), 2, 1).astype(np.int64)
               for c in (c1, c2)]
        seen[(y.astype(np.int64) << 16 | big[0] << 8 | big[1]).ravel()] = True
    return int(seen.sum()), differ


def main(argv) -> int:
    warnings.simplefilter("ignore")
    if "--fli" in argv:
        n, decoded, differ = probe_fli(int(argv[argv.index("--fli") + 1]))
        print(f"FLI: {n} files, {decoded} decoded by Pillow, {differ} "
              f"differ from the port")
    if "--pcd" in argv:
        covered, differ = probe_pcd()
        print(f"PCD: {covered} of {1 << 24} (Y, C1, C2) triples, {differ} "
              f"pixels differ from the port")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
