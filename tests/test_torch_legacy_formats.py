"""The port's readers of GIMP brushes, FLI / FLC, Windows Paint, Kodak
PhotoCD, PIXAR and XV thumbnails (cge_tpu_torch/scene/gbr.py, fli.py,
msp.py, pcd.py, pixar.py, xvthumb.py; FLI's frame chunks and MSP's rows in
native/cge_raster.cpp) against Pillow 12, which the JAX package's loader
uses: every fixture of tests/torch_textures/legacy/ against JAX's
`load_image` and its manifest's hash (or, for the files JAX refuses, a
refusal), each cut at several lengths, hand-made files of each quirk of
Pillow's plugins and C decoders (make_textures.gbr_file, fli_*, msp_file,
pcd_file, pixar_file, xv_file), the PhotoYCC tables on all 2^24 (Y, C1,
C2) triples, the native loops against Python twins, and the place of each
format in Image.open's order. Each refusal is a ValueError that names the
file and the format. Pixels must be equal exactly."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io, mesh_io, pcd
from jax_references import make_textures as mt

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_textures", "legacy")
with open(os.path.join(FOLDER, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
KINDS = {"gbr", "fli", "fli_refused", "msp", "pcd", "pixar", "pixar_refused",
         "xv"}
# Pillow's format names -> the port's
PILLOW_NAMES = {"GBR": "GBR", "FLI": "FLI", "MSP": "MSP", "PCD": "PCD",
                "PIXAR": "PIXAR", "XVThumb": "XV thumbnail"}


def _jax_u8(path):
    return np.rint(jax_image_io.load_image(path).pixels * 255.0).astype(
        np.uint8)


def _port_u8(path):
    return np.rint(mesh_io.load_image(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(tmp_path, data, name="t.tex", fmt=None):
    """The port's pixels equal JAX's; where JAX's loader raises, the port
    raises a ValueError naming the file and the format (fmt, or the one
    format_of names). JAX's pixels, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = _jax_u8(path)
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError, match=fmt or image_io.format_of(
                data)) as e:
            mesh_io.load_image(path)
        assert path in str(e.value)
        return None
    np.testing.assert_array_equal(_port_u8(path), want)
    return want


def test_fixtures_cover_every_kind():
    """The folder holds each format of this slice, refused files of FLI
    and PIXAR among them, PCD in orientations 0, 1 and 3; all its files but
    the three 768x512 PCDs stay small."""
    assert {e["kind"] for e in MANIFEST} == KINDS
    names = {e["name"] for e in MANIFEST}
    assert {f"pcd_texels_o{o}.pcd" for o in (0, 1, 3)} <= names
    assert sum(e["bytes"] for e in MANIFEST if e["kind"] != "pcd") < 32 << 10
    for e in MANIFEST:
        assert (e["sha256"] is None) == e["kind"].endswith("_refused")


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_matches_jax_and_its_hash(tmp_path, name):
    """Each fixture decodes to JAX's pixels, whose hash its manifest holds
    (the hash chip_smoke.py checks on the card's machine); a refused one
    raises in both, the port's error naming the file and the format."""
    entry = next(e for e in MANIFEST if e["name"] == name)
    path = os.path.join(FOLDER, name)
    if entry["sha256"] is None:
        data = open(path, "rb").read()
        with pytest.raises(Exception):
            _jax_u8(path)
        with pytest.raises(ValueError, match=image_io.format_of(data)) as e:
            mesh_io.load_image(path)
        assert path in str(e.value)
        return
    got = _port_u8(path)
    np.testing.assert_array_equal(got, _jax_u8(path))
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    with PIL.open(path) as im:
        assert image_io.format_of(open(path, "rb").read()) == PILLOW_NAMES[
            im.format]


@pytest.mark.parametrize("name", [e["name"] for e in MANIFEST])
def test_fixture_cut_short_matches_jax(tmp_path, name):
    """Each fixture cut at four lengths, and one byte short: JAX's pixels,
    or both refuse."""
    data = open(os.path.join(FOLDER, name), "rb").read()
    for k in (1, 2, 3, 4):
        _same_as_jax(tmp_path, data[:len(data) * k // 5], f"cut{k}.tex")
    _same_as_jax(tmp_path, data[:-1], "cut_last.tex")


# ------------------------------------------------------------------- GBR

@pytest.mark.parametrize("case,data", [
    ("v1_grey", mt.gbr_file(np.arange(12).reshape(3, 4), 1)),
    ("v2_rgba_alpha_dropped", mt.gbr_file(
        np.arange(24).reshape(2, 3, 4) * 10, 2)),
    ("v2_header_24_comment_negative", mt.gbr_file(
        np.ones((2, 2)), 2, b"", header_size=24)),
    ("v2_header_27_with_tail", mt.gbr_file(
        np.ones((2, 2)), 2, b"", header_size=27, tail=bytes(40))),
    ("comment_past_the_end", mt.gbr_file(np.ones((2, 2)), 1, b"",
                                         header_size=400)),
    ("short_body", mt.gbr_file(np.ones((3, 3, 4)), 2)[:-1]),
    ("long_body", mt.gbr_file(np.ones((3, 3)), 2, tail=b"x" * 9)),
    ("depth_3", struct.pack(">5I", 21, 1, 1, 1, 3) + b"\0" + bytes(3)),
    ("depth_2", struct.pack(">5I", 21, 1, 1, 1, 2) + b"\0" + bytes(2)),
    ("bad_magic", mt.gbr_file(np.ones((1, 1)), 2).replace(b"GIMP", b"GIMQ")),
    ("cut_at_spacing", mt.gbr_file(np.ones((1, 1)), 2)[:26]),
    ("zero_width", struct.pack(">5I", 20, 1, 0, 1, 1) + b"\0"),
    ("version_3", struct.pack(">5I", 20, 3, 1, 1, 1) + b"\0"),
    ("header_size_19", struct.pack(">5I", 19, 1, 1, 1, 1) + b"\0"),
    ("past_the_pixel_limit", struct.pack(">5I", 20, 1, 20000, 20000, 1))])
def test_gbr_cases(tmp_path, case, data):
    """GbrImagePlugin's header, comment and data: a version 2 header of 20
    to 27 bytes (its comment's read takes the rest of the file), a comment
    past the end, data cut short ("not enough image data") or longer than
    the image, and what its plugin cannot open (other depths and versions,
    no magic, a header cut short, an empty image), which no other format
    takes either."""
    _same_as_jax(tmp_path, data, fmt="GBR|unknown")


# ------------------------------------------------------------------- FLI

def _fli_twin(frame: bytes, w: int, h: int):
    """FliDecode.c's walk of a frame's sub-chunks in Python: the palette
    indices [h, w], or None where it fails."""
    im = np.zeros((h, w), np.uint8)
    n = len(frame)
    if n < 8 or struct.unpack_from("<H", frame, 4)[0] != 0xF1FA:
        return None
    ptr, left = 16, n - 16
    for _ in range(struct.unpack_from("<H", frame, 6)[0]):
        if left < 10:
            return None
        d, end = ptr + 6, ptr + left
        kind = struct.unpack_from("<H", frame, ptr + 4)[0]
        if kind == 15:
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    if d + 2 > end:
                        return None
                    c = frame[d]
                    i = 256 - c if c & 0x80 else c
                    if x + i > w:
                        break
                    if c & 0x80:
                        if d + 1 + i > end:
                            return None
                        im[y, x:x + i] = list(frame[d + 1:d + 1 + i])
                        d += 1 + i
                    else:
                        im[y, x:x + i] = frame[d + 1]
                        d += 2
                    x += i
                if x != w:
                    return None
        elif kind == 12:
            y, count = struct.unpack_from("<HH", frame, d)
            ymax, d = y + count, d + 4
            while y < ymax and y < h:
                if d + 1 > end:
                    return None
                packets, d, x, p = frame[d], d + 1, 0, 0
                while p < packets:
                    if d + 2 > end:
                        return None
                    x += frame[d]
                    c = frame[d + 1]
                    i = 256 - c if c & 0x80 else c
                    if x + i > w:
                        break
                    if c & 0x80:
                        if d + 3 > end:
                            return None
                        im[y, x:x + i] = frame[d + 2]
                        d += 3
                    else:
                        if d + 2 + i > end:
                            return None
                        im[y, x:x + i] = list(frame[d + 2:d + 2 + i])
                        d += 2 + i
                    x += i
                    p += 1
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return None
        elif kind == 7:
            lines, d = struct.unpack_from("<H", frame, d)[0], d + 2
            l = y = 0
            while l < lines and y < h:
                if d + 2 > end:
                    return None
                word, d = struct.unpack_from("<H", frame, d)[0], d + 2
                while word & 0x8000:
                    if word & 0x4000:
                        y += 65536 - word
                        if y >= h:
                            return None
                    else:
                        im[y, w - 1] = word & 0xFF
                    if d + 2 > end:
                        return None
                    word, d = struct.unpack_from("<H", frame, d)[0], d + 2
                x = p = 0
                while p < word:
                    if d + 2 > end:
                        return None
                    x += frame[d]
                    c = frame[d + 1]
                    if c >= 128:
                        if d + 4 > end:
                            return None
                        i = 256 - c
                        if x + 2 * i > w:
                            break
                        im[y, x:x + 2 * i] = list(frame[d + 2:d + 4]) * i
                        d, x = d + 4, x + 2 * i
                    else:
                        i = 2 * c
                        if x + i > w:
                            break
                        if d + 2 + i > end:
                            return None
                        im[y, x:x + i] = list(frame[d + 2:d + 2 + i])
                        d, x = d + 2 + i, x + i
                    p += 1
                if p < word:
                    break
                l, y = l + 1, y + 1
            if l < lines:
                return None
        elif kind == 13:
            im[:] = 0
        elif kind == 16:
            if d + w * h > end:
                return None
            im[:] = np.frombuffer(frame, np.uint8, w * h, d).reshape(h, w)
        elif kind not in (4, 11, 18):
            return None
        advance = struct.unpack_from("<i", frame, ptr)[0]
        if advance <= 0 or advance > left:
            return None
        ptr, left = ptr + advance, left - advance
    return im


def _random_frame(rng, w, h, lead=()):
    """A frame of the chunks lead, then random sub-chunks made by the
    writers, then damaged: bytes changed, cut."""
    chunks, prev = list(lead), np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 5))):
        new = rng.integers(0, 6, (h, w)).astype(np.uint8) * 40
        keep = rng.random((h, w)) < 0.5
        new[keep] = prev[keep]
        kind = int(rng.choice([7, 12, 13, 15, 16, 18, 4]))
        body = {7: lambda: mt.fli_ss2(prev, new),
                12: lambda: mt.fli_lc(prev, new), 13: lambda: b"",
                15: lambda: mt.fli_brun(new), 16: lambda: new.tobytes(),
                18: lambda: bytes(9),
                4: lambda: mt.fli_colors([(0, [[1, 2, 3]])])}[kind]()
        if kind in (7, 12, 15, 16):
            prev = new
        elif kind == 13:
            prev = np.zeros_like(prev)
        chunks.append(mt.fli_chunk(kind, body))
    frame = bytearray(mt.fli_frame(chunks))
    for _ in range(int(rng.integers(0, 3))):
        frame[int(rng.integers(16, len(frame)))] = int(rng.integers(0, 256))
    if rng.random() < 0.2:
        frame = frame[:int(rng.integers(8, len(frame) + 1))]
    return bytes(frame)


def test_fli_frame_against_python_twin():
    """native.fli_frame against FliDecode.c's walk in Python on seeded
    frames of every sub-chunk type, damaged: the same indices, or both
    fail."""
    rng = np.random.default_rng(271)
    decoded = 0
    for _ in range(400):
        w, h = int(rng.integers(1, 24)), int(rng.integers(1, 6))
        frame = _random_frame(rng, w, h)
        want = _fli_twin(frame, w, h)
        im = np.zeros((h, w), np.uint8)
        if want is None:
            with pytest.raises(ValueError, match="FLI"):
                native.fli_frame(frame, im)
        else:
            native.fli_frame(frame, im)
            np.testing.assert_array_equal(im, want)
            decoded += 1
    assert decoded > 100


def test_fli_random_frames_match_jax(tmp_path):
    """Seeded FLC files of random, damaged frames (and palettes) against
    JAX's loader."""
    rng = np.random.default_rng(272)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    for i in range(60):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 6))
        colours = mt.fli_chunk(4 if i % 3 else 11, mt.fli_colors(
            [(int(rng.integers(0, 9)), pal[:int(rng.integers(1, 200))])],
            0 if i % 3 else 2))
        frame = _random_frame(rng, w, h, [colours] if i % 2 else [])
        _same_as_jax(tmp_path, mt.fli_header(w, h) + frame, f"r{i}.flc",
                     fmt="FLI")


@pytest.mark.parametrize("hw", [(1, 1), (3, 7), (6, 33), (4, 300)])
def test_fli_encoders_over_frames_match_jax(tmp_path, hw):
    """Every image chunk over the one before, written by the encoders:
    COPY, then LC, SS2 and BRUN deltas of random images, at odd and even
    widths, long runs and skips, under a COLOR_64 palette."""
    h, w = hw
    rng = np.random.default_rng(w * 7 + h)
    a = rng.integers(0, 4, (h, w)).astype(np.uint8) * 60
    b = a.copy()
    b[rng.random((h, w)) < 0.3] = 5
    c = b.copy()
    c[:, :w // 2] = rng.integers(0, 256, (h, w // 2))
    d = c.copy()
    d[rng.random((h, w)) < 0.1] = 99
    pal = rng.integers(0, 64, (256, 3), dtype=np.uint8) << 2
    data = mt.fli_file([[
        mt.fli_chunk(11, mt.fli_colors([(0, pal)], 2)),
        mt.fli_chunk(16, a.tobytes()), mt.fli_chunk(12, mt.fli_lc(a, b)),
        mt.fli_chunk(7, mt.fli_ss2(b, c)),
        mt.fli_chunk(12, mt.fli_lc(c, d))]], w, h)
    want = _same_as_jax(tmp_path, data)
    np.testing.assert_array_equal(want, pal[d])
    # padded: a last sub-chunk of fewer than 10 bytes fails (fli_cases)
    data = mt.fli_header(w, h) + mt.fli_frame(
        [mt.fli_chunk(15, mt.fli_brun(d))], pad=True)
    np.testing.assert_array_equal(_same_as_jax(tmp_path, data),
                                  np.repeat(d[..., None], 3, axis=2))


_A = np.arange(12, dtype=np.uint8).reshape(3, 4)
_COPY = mt.fli_chunk(16, _A.tobytes())


def _fli_reserved():
    head = bytearray(mt.fli_header(4, 3))
    head[100] = 1
    return bytes(head) + mt.fli_frame([_COPY])


@pytest.mark.parametrize("case,data", [
    ("prefix_chunk", mt.fli_header(4, 3) + struct.pack("<IH", 16, 0xF100)
     + bytes(10) + mt.fli_frame([_COPY])),
    ("prefix_chunk_past_the_end", mt.fli_header(4, 3)
     + struct.pack("<IH", 9999, 0xF100) + bytes(10) + mt.fli_frame([_COPY])),
    ("palette_past_255", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(4, mt.fli_colors([(255, [[1, 2, 3], [4, 5, 6]])])),
         _COPY])),
    ("palette_entry_255", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(4, mt.fli_colors([(255, [[1, 2, 3]])])), _COPY])),
    ("palette_skip_past_255_at_the_end", mt.fli_header(4, 3)
     + struct.pack("<IHH8x", 99, 0xF1FA, 1) + struct.pack("<IH", 99, 4)
     + struct.pack("<H", 2) + bytes((200, 1, 7, 7, 7, 200, 1))),
    ("palette_cut_short", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(4, mt.fli_colors([(0, [[1, 2, 3], [4, 5, 6]])])[:-2])])),
    ("color64_values_wrap", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(11, struct.pack("<H", 1) + bytes((0, 2, 63, 64, 65,
                                                          200, 1, 255))),
         _COPY])),
    ("palette_after_a_chunk_of_size_0", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(18, b"", size=0),
         mt.fli_chunk(4, mt.fli_colors([(0, [[1, 2, 3]])])), _COPY])),
    ("frames_0", mt.fli_header(4, 3, frames=0) + mt.fli_frame([_COPY])),
    ("reserved_byte_set", _fli_reserved()),
    ("flags_1", mt.fli_header(4, 3, flags=1) + mt.fli_frame([_COPY])),
    ("header_only", mt.fli_header(4, 3)),
    ("no_frame_size", mt.fli_header(4, 3) + b"\x10\x00"),
    ("frame_size_0", mt.fli_header(4, 3) + mt.fli_frame([_COPY], size=0)),
    ("frame_size_2", mt.fli_header(4, 3) + mt.fli_frame([], size=2)),
    ("frame_size_past_the_end", mt.fli_header(4, 3)
     + mt.fli_frame([_COPY], size=0xFFFFFFF0)),
    ("frame_size_short", mt.fli_header(4, 3) + mt.fli_frame([_COPY],
                                                            size=20)),
    ("frame_odd_pad_missing", mt.fli_header(5, 3) + mt.fli_frame(
        [mt.fli_chunk(16, bytes(range(15)))])),
    ("frame_not_a_frame", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY], kind=0xF1FB)),
    ("unknown_chunk", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(5, bytes(4))])),
    ("chunk_size_0", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(13, b"", size=0), _COPY])),
    ("chunk_size_past_the_frame", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(16, _A.tobytes(), size=40)])),
    ("chunk_count_past_the_chunks", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY], count=2)),
    ("copy_cut_short", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(16, bytes(11))])),
    ("copy_cut_short_file_goes_on", mt.fli_header(4, 3) + mt.fli_frame(
        [mt.fli_chunk(16, bytes(11))]) + bytes(64)),
    ("brun_run_past_the_line", mt.fli_header(4, 1) + mt.fli_frame(
        [mt.fli_chunk(15, bytes((1, 5, 9)))])),
    ("brun_literal_past_the_data", mt.fli_header(4, 1) + mt.fli_frame(
        [mt.fli_chunk(15, bytes((1, 252, 1, 2)))])),
    ("last_chunk_under_10_bytes", mt.fli_header(1, 1) + mt.fli_frame(
        [mt.fli_chunk(15, bytes((1, 255, 7)))])),
    ("last_chunk_padded", mt.fli_header(1, 1) + mt.fli_frame(
        [mt.fli_chunk(15, bytes((1, 255, 7)))], pad=True)),
    ("brun_zero_runs", mt.fli_header(4, 1) + mt.fli_frame(
        [mt.fli_chunk(15, bytes((3, 0, 8, 0, 9, 4, 7)))])),
    ("lc_run_past_the_line", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(12, struct.pack("<HH", 0, 2)
                             + bytes((1, 2, 253, 9, 1, 0, 1, 5)))])),
    ("lc_lines_past_the_image", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(12, struct.pack("<HH", 2, 2) + bytes(2))])),
    ("lc_skip_past_the_line", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(12, struct.pack("<HH", 1, 1)
                             + bytes((1, 9, 0)))])),
    ("ss2_skip_past_the_image", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(7, struct.pack("<HHH", 1, 65536 - 3, 0))])),
    ("ss2_last_byte_and_skip", mt.fli_header(5, 3) + mt.fli_frame(
        [mt.fli_chunk(16, bytes(range(15))), mt.fli_chunk(
            7, struct.pack("<HHHHB", 1, 65536 - 1, 0x80AB, 1, 1)
            + bytes((0xFE, 7, 8)))])),
    ("ss2_run_past_the_line", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(7, struct.pack("<HH", 2, 1) + bytes(
            (2, 254, 7, 8)) + struct.pack("<H", 0))])),
    ("ss2_cut_short", mt.fli_header(4, 3) + mt.fli_frame(
        [_COPY, mt.fli_chunk(7, struct.pack("<HH", 1, 1)
                             + bytes((0, 2, 1)))])),
    ("huge_image", mt.fli_header(40000, 40000) + mt.fli_frame([]))])
def test_fli_cases(tmp_path, case, data):
    """FliImagePlugin's header, palette search and frame reads, and
    FliDecode.c's walk: a prefix chunk (the palette is found past it, the
    decoder fails at it), palette indices past 255 (Pillow cannot open the
    file), a skip past 255 that sets no entry, COLOR_64 values past 63
    (shifted and kept to 8 bits), a palette after a sub-chunk of size 0 (not
    found), 0 frames, reserved bytes and flags, frame sizes of 0, 2, past
    the file and short of its chunks, a missing pad byte, an unknown chunk
    type, chunk sizes of 0 and past the frame, runs past a line or the
    data, lines and skips past the image, an odd width's last byte, and an
    image past Pillow's limit, and a last sub-chunk of fewer than 10
    bytes (the decoder wants 10 for any chunk's header)."""
    _same_as_jax(tmp_path, data, fmt="FLI|unknown")


def test_fli_palette_search_follows_pillow():
    """The palette _open finds: grey without one, COLOR_256 as it is and
    COLOR_64 shifted, packets skipping entries, a count of 0 setting 256
    entries."""
    from cge_tpu_torch.scene import fli

    pal = np.arange(768, dtype=np.uint32).reshape(256, 3) % 256
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    data = mt.fli_header(2, 1) + mt.fli_frame([_COPY])
    np.testing.assert_array_equal(fli.palette(data), grey)
    data = mt.fli_header(2, 1) + mt.fli_frame([mt.fli_chunk(
        4, mt.fli_colors([(0, pal.astype(np.uint8))]))])
    np.testing.assert_array_equal(fli.palette(data), pal)
    want = grey.copy()
    want[3:5] = [[4, 8, 12], [16, 20, 24]]
    want[9] = [252, 0, 4]
    data = mt.fli_header(2, 1) + mt.fli_frame([mt.fli_chunk(
        11, struct.pack("<H", 2) + bytes((3, 2, 1, 2, 3, 4, 5, 6, 4, 1,
                                          63, 64, 1)))])
    np.testing.assert_array_equal(fli.palette(data), want)


# ------------------------------------------------------------------- MSP

def _msp_twin(data: bytes, w: int, h: int):
    """MspDecoder in Python, as its plugin reads a LinS file's rows, the
    image's bytes joined; None where it raises."""
    stride = (w + 7) // 8
    pos = 32 + 2 * h
    if pos > len(data):
        return None
    out = bytearray()
    for r, n in enumerate(struct.unpack_from(f"<{h}H", data, 32)):
        if not n:
            out += b"\xff" * stride
            continue
        row = data[pos:pos + n]
        pos += n
        if len(row) != n:
            return None
        i = 0
        while i < n:
            t = row[i]
            i += 1
            if t == 0:
                if i + 2 > n:
                    return None
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + t]
                i += t
    if len(out) < h * stride:
        return None
    return np.frombuffer(bytes(out[:h * stride]), np.uint8).reshape(
        h, stride)


def test_msp_rle_against_python_twin():
    """native.msp_rle against MspDecoder's loop in Python on seeded row
    maps and rows: runs, literals past a row's end, white rows, cut runs
    and rows, streams too short or long."""
    rng = np.random.default_rng(273)
    decoded = 0
    for _ in range(400):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 6))
        stride = (w + 7) // 8
        rows = []
        for _ in range(h):
            row = bytearray()
            for _ in range(int(rng.integers(0, 4))):
                if rng.random() < 0.4:
                    row += bytes((0, int(rng.integers(0, 2 * stride + 1)),
                                  int(rng.integers(0, 256))))
                else:
                    k = int(rng.integers(1, 2 * stride + 2))
                    row += bytes((k,)) + bytes(rng.integers(
                        0, 256, int(rng.integers(0, k + 1)), np.uint8))
            rows.append(bytes(row))
        lengths = tuple(map(len, rows))
        body = b"".join(rows)
        if rng.random() < 0.2:
            body = body[:int(rng.integers(0, len(body) + 1))]
        data = bytes(32) + struct.pack(f"<{h}H", *lengths) + body
        want = _msp_twin(data, w, h)
        if want is None:
            with pytest.raises(ValueError, match="MSP"):
                native.msp_rle(data, 32 + 2 * h, lengths, stride, "MSP")
        else:
            np.testing.assert_array_equal(native.msp_rle(
                data, 32 + 2 * h, lengths, stride, "MSP"), want)
            decoded += 1
    assert decoded > 100


_BITS = np.random.default_rng(274).integers(0, 2, (4, 19))
_PACKED = np.packbits(_BITS.astype(np.uint8), axis=1)


def _lins(rows, bits=_BITS):
    return mt.msp_file(bits, rows=rows)


@pytest.mark.parametrize("case,data", [
    ("danm", mt.msp_file(_BITS, b"DanM")),
    ("danm_cut", mt.msp_file(_BITS, b"DanM")[:-1]),
    ("danm_long", mt.msp_file(_BITS, b"DanM") + b"\x01\x02"),
    ("lins", mt.msp_file(_BITS)),
    ("bad_checksum", mt.msp_file(_BITS, checksum=False)),
    ("header_cut", mt.msp_file(_BITS)[:31]),
    ("zero_width", mt.msp_file(np.zeros((2, 0), np.uint8), b"DanM")),
    ("row_map_cut", mt.msp_file(_BITS)[:32 + 5]),
    ("white_rows", _lins([b"", mt.msp_row(_PACKED[1]), b"", b""])),
    ("row_decodes_long", _lins([mt.msp_row(r) for r in _PACKED[:2]]
                               + [mt.msp_row(_PACKED[2]) + b"\x02\x0f\xf0",
                                  mt.msp_row(_PACKED[3])])),
    ("row_decodes_short", _lins([mt.msp_row(r) for r in _PACKED[:3]]
                                + [b"\x02\x0f\xf0"])),
    ("literal_past_the_row", _lins([b"\x07\x01", b"\x00\x08\x55",
                                    b"\x01\x00", b"\x00\x03\xaa"])),
    ("run_cut_after_its_count", _lins([b"\x00\x03", b"", b"", b""])),
    ("run_cut_after_its_zero", _lins([b"\x03\x01\x02\x03\x00", b"", b"",
                                      b""])),
    ("row_cut_by_the_file", _lins([mt.msp_row(r) for r in _PACKED])[:-2]),
    ("runs_of_zero", _lins([b"\x00\x00\x11" + mt.msp_row(_PACKED[0])]
                           + [mt.msp_row(r) for r in _PACKED[1:]]))])
def test_msp_cases(tmp_path, case, data):
    """MspImagePlugin's header (its checksum, an empty image, a header cut
    short: not opened) and DanM's raw rows; MspDecoder's row map, white
    rows of length 0, rows that decode long or short (the rows after them
    shift), a literal past its row's end, runs cut short, a row the file
    cuts, and runs of 0 bytes."""
    _same_as_jax(tmp_path, data, fmt="MSP|unknown")


# ------------------------------------------------------------------- PCD

_N = 256 * 384                       # chroma samples a file


@pytest.mark.parametrize("part", range(43))
def test_pcd_every_ycc_triple(tmp_path, part):
    """Pillow's "YCC;P" conversion on all 2^24 (Y, C1, C2) triples, every
    entry of each PhotoYCC table among them: 43 PCD files of 98,304 chroma
    samples, each with its four luma samples (64 samples a (C1, C2) pair
    cover its 256 Y values), against JAX's loader."""
    s = np.arange(part * _N, (part + 1) * _N) % (65536 * 64)
    pair, j = s // 64, s % 64
    c1 = (pair // 256).astype(np.uint8).reshape(256, 384)
    c2 = (pair % 256).astype(np.uint8).reshape(256, 384)
    y4 = (4 * j[:, None] + np.arange(4)).astype(np.uint8).reshape(256, 384,
                                                                   2, 2)
    y = y4.transpose(0, 2, 1, 3).reshape(512, 768)
    want = _same_as_jax(tmp_path, mt.pcd_file(y, c1, c2), f"p{part}.pcd")
    big = lambda c: np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)  # noqa
    np.testing.assert_array_equal(want, pcd.ycc_to_rgb(y, big(c1), big(c2)))


def test_pcd_tables_entry_by_entry(tmp_path):
    """Every entry of each table takes part in some output that no clip
    hides, so test_pcd_every_ycc_triple pins it (up to the constant that
    a sum of two tables shares); and the probe Y 95, C2 73 gives R 13 in
    Pillow and in the port."""
    y = np.arange(256)[:, None]
    for table in (pcd.CR, pcd.CB):
        s = pcd.L[y] + table[None]
        assert (((s > 0) & (s < 255)).any(axis=0)).all()
        assert (((s > 0) & (s < 255)).any(axis=1)).all()
    for a, b in ((pcd.GB, pcd.GR), (pcd.GR, pcd.GB)):
        s = pcd.L[y, None] + a[None, :, None] + b[None, None]
        assert (((s > 0) & (s < 255)).any(axis=(0, 2))).all()
    data = mt.pcd_file(np.full((512, 768), 95, np.uint8),
                       np.zeros((256, 384), np.uint8),
                       np.full((256, 384), 73, np.uint8))
    want = _same_as_jax(tmp_path, data)
    assert (want[..., 0] == 13).all()


@pytest.mark.parametrize("orientation", range(8))
def test_pcd_orientations(tmp_path, orientation):
    """The orientation byte's low two bits: 1 and 3 turn the image by 90
    and 270 degrees (768 high), the others leave it; the higher bits are
    not read."""
    rng = np.random.default_rng(orientation)
    y = rng.integers(0, 256, (512, 768), np.uint8)
    c1, c2 = rng.integers(0, 256, (2, 256, 384), np.uint8)
    want = _same_as_jax(tmp_path, mt.pcd_file(y, c1, c2, orientation * 33))
    assert want.shape == ((768, 512, 3) if orientation * 33 & 3 in (1, 3)
                          else (512, 768, 3))


@pytest.mark.parametrize("cut", [2052, 3586, 3587, 96 * 2048,
                                 96 * 2048 + 2303, 786431])
def test_pcd_cut_short(tmp_path, cut):
    """Cut before the orientation byte (not a PCD file to Pillow), or
    before the base image's last chunk (truncated): both refuse."""
    rng = np.random.default_rng(cut)
    data = mt.pcd_file(rng.integers(0, 256, (512, 768), np.uint8),
                       *rng.integers(0, 256, (2, 256, 384), np.uint8))
    assert _same_as_jax(tmp_path, data[:cut], fmt="PCD") is None


# ---------------------------------------------------------- PIXAR and XV

@pytest.mark.parametrize("case,data", [
    ("rgb", mt.pixar_file(np.arange(36).reshape(3, 4, 3))),
    ("rgb_tail", mt.pixar_file(np.ones((2, 5, 3)), tail=b"\x01")),
    ("rgb_cut", mt.pixar_file(np.ones((2, 5, 3)))[:-1]),
    ("channels_14_depth_1", mt.pixar_file(np.ones((2, 5, 3)), 14, 1)),
    ("channels_15_depth_2", mt.pixar_file(np.ones((2, 5, 3)), 15, 2)),
    ("channels_0_depth_0", mt.pixar_file(np.ones((2, 5, 3)), 0, 0)),
    ("header_427_bytes", mt.pixar_file(np.ones((2, 5, 3)))[:427]),
    ("header_428_bytes", mt.pixar_file(np.ones((2, 5, 3)))[:428]),
    ("zero_height", mt.pixar_file(np.ones((0, 5, 3))))])
def test_pixar_cases(tmp_path, case, data):
    """PixarImagePlugin: RGB for channels 14 and depth 2 only, any other
    pair (and an empty image, a header cut before its codes) not opened,
    data cut short or longer than the image."""
    _same_as_jax(tmp_path, data, fmt="PIXAR")


_IDX = np.arange(12, dtype=np.uint8).reshape(3, 4) * 21


@pytest.mark.parametrize("case,data", [
    ("comments", mt.xv_file(_IDX)),
    ("no_comments", mt.xv_file(_IDX, ())),
    ("rest_of_magic_line", mt.xv_file(_IDX, rest=b" thumbnail junk")),
    ("extra_fields", mt.xv_file(_IDX, size_line=b"4 3 255 more")),
    ("tabs_and_signs", mt.xv_file(_IDX, size_line=b"\t+4\x0b3 ")),
    ("underscore_digits", mt.xv_file(np.zeros((1, 10), np.uint8),
                                     size_line=b"1_0 1")),
    ("one_field", mt.xv_file(_IDX, size_line=b"12")),
    ("empty_size_line", mt.xv_file(_IDX, size_line=b" ")),
    ("not_a_number", mt.xv_file(_IDX, size_line=b"4 x")),
    ("negative", mt.xv_file(_IDX, size_line=b"-4 3")),
    ("zero", mt.xv_file(_IDX, size_line=b"0 3")),
    ("hex", mt.xv_file(_IDX, size_line=b"0x4 3")),
    ("cut_data", mt.xv_file(_IDX)[:-1]),
    ("long_data", mt.xv_file(_IDX) + b"\x01\x02"),
    ("eof_in_comments", b"P7 332\n#only a comment\n"),
    ("carriage_returns", b"P7 332\r4 3\r" + _IDX.tobytes()),
    ("no_newline", b"P7 332 4 3 " + _IDX.tobytes())])
def test_xv_cases(tmp_path, case, data):
    """XVThumbImagePlugin: the rest of the magic's line and '#' lines
    passed over, the size line's first two fields through int() (signs,
    whitespace, underscores; fewer fields, other text and hex refused), an
    empty image or the end of the file before the size line not opened,
    data cut short or longer than the image."""
    want = _same_as_jax(tmp_path, data, fmt="XV thumbnail")
    if case == "comments":
        np.testing.assert_array_equal(want, image_io.xvthumb.PALETTE[_IDX])


def test_xv_palette_is_rgb332():
    """Pillow's XV palette is the 3-3-2 palette: red from the top three
    bits, green from the next three, blue from the last two."""
    i = np.arange(256)
    np.testing.assert_array_equal(image_io.xvthumb.PALETTE, np.stack(
        [(i >> 5) * 255 // 7, (i >> 2 & 7) * 255 // 7, (i & 3) * 255 // 3],
        axis=1))
    rgb = np.random.default_rng(5).integers(0, 256, (9, 3), np.uint8)
    idx = mt.rgb332(rgb)
    assert ((image_io.xvthumb.PALETTE[idx] >> 5) == (rgb >> 5))[:, 0].all()


# -------------------------------------------------------------- dispatch

def _msp_that_starts_as_fli():
    """A DanM file whose first 16 bytes FLI's test takes (its width is
    0xAF11), whose pixel bytes fill FLI's reserved bytes: FLI's plugin
    cannot open it, MSP's can."""
    head = bytearray(32)
    head[:4] = b"DanM"
    struct.pack_into("<HH", head, 4, 0xAF11, 1)
    words = np.frombuffer(bytes(head), "<u2")
    struct.pack_into("<H", head, 30, int(np.bitwise_xor.reduce(words)))
    return bytes(head) + bytes(range(256)) * 22


def _pcd_with_head(head: bytes) -> bytes:
    data = mt.pcd_file(np.full((512, 768), 90, np.uint8),
                       np.full((256, 384), 100, np.uint8),
                       np.full((256, 384), 140, np.uint8))
    return head + data[len(head):]


@pytest.mark.parametrize("case,fmt,opens_as", [
    ("msp_before_pcd", "MSP", "MSP"),
    ("pcd_before_pixar", "PCD", "PCD"),
    ("pixar_of_another_mode", "PIXAR", None),
    ("fli_damaged_header_opens_as_msp", "FLI", "MSP"),
    ("gbr_header_cut_as_nothing", "unknown", None),
    ("xv_thumbnail_not_pnm", "XV thumbnail", "XVThumb")])
def test_each_format_in_pillows_order(tmp_path, case, fmt, opens_as):
    """The plugin Image.open settles on is the one the port decodes with:
    MSP before PCD (a LinS header over a PCD), PCD before PIXAR (a PIXAR
    magic over a PCD), a PIXAR of another mode that no plugin opens, an
    FLI-looking MSP whose reserved bytes send Pillow on to MSP, a GBR cut
    before its spacing, and "P7 332", which PNM's test does not take."""
    data = {
        "msp_before_pcd": lambda: _pcd_with_head(mt.msp_file(
            np.ones((2, 8), np.uint8), b"DanM")),
        "pcd_before_pixar": lambda: _pcd_with_head(mt.pixar_file(
            np.ones((1, 1, 3)))[:1024]),
        "pixar_of_another_mode": lambda: mt.pixar_file(np.ones((2, 2, 3)),
                                                       3, 2),
        "fli_damaged_header_opens_as_msp": _msp_that_starts_as_fli,
        "gbr_header_cut_as_nothing": lambda: mt.gbr_file(np.ones((1, 1)),
                                                         2)[:27],
        "xv_thumbnail_not_pnm": lambda: mt.xv_file(_IDX)}[case]()
    assert image_io.format_of(data) == fmt
    path = str(tmp_path / "t.tex")
    open(path, "wb").write(data)
    if opens_as is None:
        with pytest.raises(Exception):
            PIL.open(path)
    else:
        with PIL.open(path) as im:
            assert im.format == opens_as
    want = _same_as_jax(tmp_path, data, fmt=fmt)
    assert (want is None) == (opens_as is None)


def test_decodes_without_pillow(monkeypatch):
    """The mesh loader's texture path with Pillow blocked: every fixture
    JAX decodes decodes through image_io.format_of to JAX's pixels, and
    format_of names the formats of this slice."""
    import builtins

    want = {e["name"]: _jax_u8(os.path.join(FOLDER, e["name"]))
            for e in MANIFEST if e["sha256"]}
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    for name, pixels in want.items():
        path = os.path.join(FOLDER, name)
        fmt = image_io.format_of(open(path, "rb").read())
        assert fmt in ("GBR", "FLI", "MSP", "PCD", "PIXAR", "XV thumbnail")
        assert fmt in image_io.READ
        np.testing.assert_array_equal(_port_u8(path), pixels, err_msg=name)


def test_read_names_the_formats_in_pillows_order():
    """READ holds the six formats; PCD sits between MSP and PIXAR, as in
    Pillow's Image.ID, and no decoder of the six is missing."""
    order = [n for n, _, _ in image_io._PILLOW_ORDER]
    for name in ("GBR", "FLI", "MSP", "PCD", "PIXAR", "XV thumbnail"):
        assert name in image_io.READ
    assert order.index("MSP") + 1 == order.index("PCD") == \
        order.index("PIXAR") - 1
    PIL.init()
    ids = [i for i in PIL.ID if i in ("MSP", "PCD", "PIXAR")]
    assert ids == ["MSP", "PCD", "PIXAR"]


def test_chip_smoke_writers_hold_their_texels():
    """chip_smoke.py phase 18c's writers of these formats (legacy_writers):
    each file decodes, in the port and in Pillow, to the texels it says it
    holds."""
    import chip_smoke

    texels = np.random.default_rng(3).integers(0, 256, (128, 128, 3),
                                               dtype=np.uint8)
    out = chip_smoke.legacy_writers(texels)
    assert {image_io.format_of(d) for d, _ in out.values()} == {
        "GBR", "FLI", "MSP", "PIXAR", "XV thumbnail"}
    for name, (data, held) in out.items():
        np.testing.assert_array_equal(image_io.decode_image(data), held,
                                      err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")), held,
            err_msg=name)
