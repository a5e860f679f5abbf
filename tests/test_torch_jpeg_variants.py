"""The port's JPEG decoder (cge_tpu_torch/native/cge_jpeg.cpp through
scene/jpeg.py) on the variants that Pillow opens but does not write,
against the JAX package's `load_image` (Pillow 12 and its libjpeg-turbo
3.1), pixel for pixel in u8 (tolerance 0):

  - the committed fixtures of jax_references/make_textures.py's
    jpeg_variant_fixtures, by the manifest's hash too;
  - files written here through Pillow's own libjpeg-turbo compressor
    (make_textures.jpeg_encode): every whole sampling ratio (fancy h2v1,
    h2v2 and h1v2 upsampling and replication, at widths of 1 to 4 and
    more), Adobe RGB, CMYK and YCCK with and without the Adobe marker,
    arithmetic coding with restarts and DAC conditioning, scan scripts
    that leave coefficients unrefined (block smoothing) under both
    codings, lossless at each predictor and point transform (and, by
    make_textures.lossless_jpeg, at samplings libjpeg does not write
    lossless), and random
    files of all of these (hypothesis), at random sizes with odd widths
    and 1-row and 1-column images;
  - damaged arithmetic and smoothed progressive files (bytes flipped,
    inserted or taken out of the scans), equal to Pillow's pixels or
    refused where Pillow refuses them;
  - arithmetic files padded across Pillow's 64 KB read blocks, which
    Pillow decodes or refuses by where each scan lies;
  - each case Pillow refuses (make_textures.JPEG_REFUSED), which raises a
    ValueError that names the file and the case.
"""

import hashlib
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cge_tpu.scene import image_io as jax_image_io
from cge_tpu_torch.scene import image_io
from jax_references import make_textures

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_textures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
# the new kinds: every JPEG fixture but the baseline and progressive files
# Pillow writes
VARIANTS = [f for f in MANIFEST["files"] if f["name"].endswith(".jpg")
            and f["name"].startswith(("jpeg_sampling_", "jpeg_cmyk_",
                                      "jpeg_ycck", "jpeg_arith_",
                                      "jpeg_smooth_", "jpeg_lossless_"))]


def _u8(load, path):
    return np.rint(load(path).pixels * 255.0).astype(np.uint8)


def _same_as_jax(path):
    """The port's pixels equal JAX's, or both refuse the file (the port
    with a ValueError naming the file)."""
    try:
        want = _u8(jax_image_io.load_image, path)
    except Exception:                     # noqa: BLE001 (Pillow's errors)
        with pytest.raises(ValueError) as e:
            image_io.load_image(path)
        assert path in str(e.value)
        return None
    got = _u8(image_io.load_image, path)
    np.testing.assert_array_equal(got, want)
    return got


def _write(tmp_path, data, name="t.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def test_variant_fixtures_cover_the_new_kinds():
    names = {f["name"] for f in VARIANTS}
    assert len(VARIANTS) == 45
    assert make_textures.JPEG_CROP_NAME in names
    assert sum(f["bytes"] for f in VARIANTS) < 60_000


@pytest.mark.parametrize("name", [f["name"] for f in VARIANTS])
def test_variant_fixture_matches_jax(name):
    entry = next(f for f in VARIANTS if f["name"] == name)
    got = _same_as_jax(os.path.join(FIXTURES, name))
    assert got is not None and list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


SIZES = [(21, 19), (1, 9), (9, 1), (2, 3), (17, 4), (40, 33)]


@pytest.mark.parametrize("arithmetic", [False, True])
@pytest.mark.parametrize("sampling", sorted(make_textures.SAMPLINGS))
def test_samplings_match_jax(tmp_path, sampling, arithmetic):
    """Each whole sampling ratio at sizes down to 1 row or column (the
    fancy filters' narrow cases), Huffman and arithmetic."""
    rng = np.random.default_rng(len(sampling) * 7 + arithmetic)
    for h, w in SIZES:
        px = make_textures.smooth_image(rng, h, w, 10.0)
        data = make_textures.jpeg_encode(
            px, quality=80, arithmetic=arithmetic,
            sampling=make_textures.SAMPLINGS[sampling])
        assert _same_as_jax(_write(tmp_path, data)) is not None


@pytest.mark.parametrize("case", [
    dict(), dict(adobe=False), dict(colorspace="ycck"),
    dict(colorspace="ycck", adobe=False),
    dict(colorspace="ycck", sampling=[(1, 2), (1, 1), (1, 1), (1, 2)]),
    dict(sampling=[(2, 1), (1, 1), (1, 1), (2, 1)], progressive=True),
    dict(colorspace="ycck", arithmetic=True, restart=1),
    dict(colorspace="rgb", sampling=[(2, 2), (1, 1), (1, 1)]),
    dict(colorspace="rgb", adobe=False)],
    ids=["cmyk", "cmyk_no_adobe", "ycck", "ycck_no_adobe", "ycck_440",
         "cmyk_422_progressive", "ycck_arith_restart", "adobe_rgb_420",
         "rgb_no_adobe"])
def test_cmyk_ycck_and_rgb_match_jax(tmp_path, case):
    """Four components as Adobe CMYK (transform 0 or no marker) and YCCK
    (transform 2; without the marker libjpeg reads it as CMYK), then
    Pillow's inverted CMYK to RGB; RGB with and without the Adobe marker
    (the component ids R, G, B)."""
    rng = np.random.default_rng(3)
    for h, w in SIZES:
        px = make_textures.smooth_image(rng, h, w, 10.0)
        if case.get("colorspace") != "rgb":
            px = make_textures.cmyk_of(px)
        data = make_textures.jpeg_encode(px, quality=85, **case)
        assert _same_as_jax(_write(tmp_path, data)) is not None


@pytest.mark.parametrize("arithmetic", [False, True])
@pytest.mark.parametrize("script", sorted(make_textures.SMOOTH_SCANS))
def test_unrefined_scans_are_smoothed_as_jax(tmp_path, script, arithmetic):
    """Progressive files whose scans leave a low coefficient unrefined:
    libjpeg's block smoothing, DC only (its Gaussian kernel, the DC
    changed too) and with AC bands at Al > 0 (the 5x5 estimates), at
    sizes whose last iMCU row is cut short, with restarts."""
    rng = np.random.default_rng(11 + arithmetic)
    scans = make_textures.SMOOTH_SCANS[script]
    for (h, w), samp, restart in zip(
            SIZES + [(43, 37), (25, 70)],
            [None, [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]] * 3,
            [0, 2, 0, 5, 0, 1, 0, 3]):
        px = make_textures.smooth_image(rng, h, w, 20.0)
        data = make_textures.jpeg_encode(px, quality=60, scans=scans,
                                         sampling=samp, restart=restart,
                                         arithmetic=arithmetic)
        assert _same_as_jax(_write(tmp_path, data)) is not None


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_predictors_match_jax(tmp_path, psv):
    """Lossless (SOF3) at predictor psv: grey, RGB and CMYK, each point
    transform, with and without restarts (whole MCU rows)."""
    rng = np.random.default_rng(psv)
    for (h, w), pt, rows in zip(SIZES, [0, 1, 2, 3, 4, 7], [0, 1, 0, 2, 3, 1]):
        px = make_textures.smooth_image(rng, h, w, 30.0)
        for img in (px[..., :1], px, make_textures.cmyk_of(px)):
            data = make_textures.jpeg_encode(img, lossless=(psv, pt),
                                             restart_rows=rows)
            assert _same_as_jax(_write(tmp_path, data)) is not None


@pytest.mark.parametrize("factors", [
    [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
    [(4, 1), (1, 1), (1, 1)], [(2, 1), (1, 1), (2, 1)],
    [(1, 1), (2, 2), (1, 2)]],
    ids=["420", "440", "411", "mixed", "chroma_up"])
def test_subsampled_lossless_matches_jax(tmp_path, factors):
    """Lossless files whose components are subsampled, which libjpeg's
    compressor does not write (make_textures.lossless_jpeg writes them):
    one interleaved scan of each component's h x v samples an MCU, the
    samples replicated (libjpeg's upsampling is never fancy in lossless
    mode), at sizes down to 1 row or column, each predictor and restarts
    of 1 and 2 MCU rows."""
    rng = np.random.default_rng(len(factors[0]) + factors[0][0])
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    for (h, w), psv, rows in zip(SIZES, (1, 2, 3, 4, 5, 6, 7),
                                 (0, 1, 2, 0, 1, 2)):
        px = make_textures.smooth_image(rng, h, w, 30.0)
        planes = [px[::vmax // v, ::hmax // hs, i]
                  for i, (hs, v) in enumerate(factors)]
        data = make_textures.lossless_jpeg(planes, factors, psv, psv % 3,
                                           rows)
        assert _same_as_jax(_write(tmp_path, data)) is not None


def _scan_script(draw, nc):
    """A random progressive script libjpeg's compressor takes: the DC
    first (all components, or each alone) at some Al, bands of AC at some
    Al each, refined part of the way or not at all, some left out."""
    al_dc = draw(st.integers(0, 2))
    comps = tuple(range(nc))
    if nc > 1 and draw(st.booleans()):
        scans = [((c,), 0, 0, 0, al_dc) for c in comps]
    else:
        scans = [(comps, 0, 0, 0, al_dc)]
    for c in comps:
        cut = draw(st.integers(1, 63))
        for ss, se in ((1, cut), (cut + 1, 63)):
            if ss > se or draw(st.integers(0, 3)) == 0:
                continue
            al = draw(st.integers(0, 2))
            scans.append(((c,), ss, se, 0, al))
            for a in range(al, draw(st.integers(0, al)), -1):
                scans.append(((c,), ss, se, a, a - 1))
    for a in range(al_dc, draw(st.integers(0, al_dc)), -1):
        scans.append((comps, 0, 0, a, a - 1))
    return scans


def _factors(draw, nc):
    """Sampling factors 1-4 of nc components with whole ratios to the
    largest (hm x vm, which one component has) and at most 10 blocks an
    MCU."""
    hm, vm = draw(st.sampled_from([(h, v) for h in (1, 2, 3, 4)
                                   for v in (1, 2, 4)
                                   if h * v <= 11 - nc]))
    out = [(draw(st.sampled_from([d for d in (1, 2, 3, 4) if hm % d == 0])),
            draw(st.sampled_from([d for d in (1, 2, 4) if vm % d == 0])))
           for _ in range(nc)]
    top = draw(st.integers(0, nc - 1))
    out[top] = (hm, vm)
    if sum(h * v for h, v in out) > 10:
        out = [(hm, vm) if i == top else (1, 1) for i in range(nc)]
    return out


@st.composite
def _variant_files(draw):
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    nc = draw(st.sampled_from([1, 3, 3, 4]))
    kw = {}
    if draw(st.integers(0, 4)) == 0:
        kw["lossless"] = (draw(st.integers(1, 7)), draw(st.integers(0, 3)))
        kw["restart_rows"] = draw(st.sampled_from([0, 0, 1, 2]))
    else:
        kw["quality"] = draw(st.integers(20, 95))
        if nc == 3:
            kw["colorspace"] = draw(st.sampled_from([None, "rgb"]))
        elif nc == 4:
            kw["colorspace"] = draw(st.sampled_from([None, "ycck"]))
        if nc > 1:
            kw["sampling"] = _factors(draw, nc)
        kw["adobe"] = draw(st.sampled_from([None, None, True, False]))
        kw["arithmetic"] = draw(st.booleans())
        mode = draw(st.sampled_from(["sequential", "progressive", "script"]))
        if mode == "progressive":
            kw["progressive"] = True
        elif mode == "script":
            kw["scans"] = _scan_script(draw, nc)
        kw["restart"] = draw(st.sampled_from([0, 0, 1, 3]))
        if kw["arithmetic"] and draw(st.booleans()):
            lo = draw(st.integers(0, 15))
            kw["conditioning"] = {0: (lo, draw(st.integers(lo, 15)),
                                      draw(st.integers(1, 63)))}
    return h, w, nc, kw, draw(st.integers(0, 2 ** 32 - 1))


@settings(max_examples=100, deadline=None, derandomize=True)
@given(case=_variant_files())
def test_random_variants_match_jax(tmp_path_factory, case):
    """Random files of every variant: size, components, colour space,
    sampling, Adobe marker, coding, scan script, restarts, conditioning,
    lossless predictor and point transform."""
    h, w, nc, kw, seed = case
    px = make_textures.smooth_image(np.random.default_rng(seed), h, w,
                                    15.0)
    img = {1: px[..., :1], 3: px, 4: make_textures.cmyk_of(px)}[nc]
    data = make_textures.jpeg_encode(img, **kw)
    path = _write(tmp_path_factory.mktemp("v"), data)
    assert _same_as_jax(path) is not None


def _damage(rng, data, mode):
    """Bytes flipped, inserted or taken out between the first scan and
    the EOI (which stays)."""
    data = bytearray(data)
    lo = data.find(b"\xff\xda") + 14
    j = int(rng.integers(lo, len(data) - 2))
    if mode == "flip":
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(lo, len(data) - 2))
            data[k] ^= int(rng.integers(1, 256))
    elif mode == "insert":
        data[j:j] = rng.integers(0, 256, int(rng.integers(1, 20)),
                                 dtype=np.uint8).tobytes()
    else:
        del data[j:min(j + int(rng.integers(1, 30)), len(data) - 2)]
    return bytes(data)


@pytest.mark.parametrize("mode", ["flip", "insert", "cut"])
@pytest.mark.parametrize("seed", range(4))
def test_damaged_arithmetic_files_match_jax(tmp_path, seed, mode):
    """Damaged arithmetic data: libjpeg warns and goes on (zeros past a
    marker, nothing more in an interval after a decoding error, the
    restart markers resynchronised), and Pillow ignores the warnings; the
    pixels equal Pillow's, or both refuse the file."""
    rng = np.random.default_rng(100 + seed)
    for k in range(6):
        px = make_textures.smooth_image(rng, int(rng.integers(8, 50)),
                                        int(rng.integers(8, 50)), 20.0)
        data = make_textures.jpeg_encode(
            px, arithmetic=True, progressive=bool(k % 2),
            restart=int(rng.choice([0, 2, 5])), quality=70,
            sampling=[None, [(2, 2), (1, 1), (1, 1)]][k % 3 == 2])
        _same_as_jax(_write(tmp_path, _damage(rng, data, mode)))


@pytest.mark.parametrize("mode", ["flip", "insert", "cut"])
@pytest.mark.parametrize("seed", range(4))
def test_damaged_smoothed_files_match_jax(tmp_path, seed, mode):
    """Damaged progressive files that are smoothed, under both codings:
    the Huffman decoder's libjpeg rules too (a segment cut short by a
    marker reads as empty MCUs up to the next restart, and the rows past
    the last one the last scan reached are smoothed with the coefficient
    bits from before it)."""
    rng = np.random.default_rng(200 + seed)
    names = sorted(make_textures.SMOOTH_SCANS)
    for k in range(6):
        px = make_textures.smooth_image(rng, int(rng.integers(8, 50)),
                                        int(rng.integers(8, 50)), 20.0)
        data = make_textures.jpeg_encode(
            px, arithmetic=bool(k % 2), quality=70,
            scans=make_textures.SMOOTH_SCANS[names[k % len(names)]],
            restart=int(rng.choice([0, 2, 5])))
        _same_as_jax(_write(tmp_path, _damage(rng, data, mode)))


def _com(n):
    out = b""
    while n > 0:
        k = min(n, 65000)
        out += b"\xff\xfe" + (k + 2).to_bytes(2, "big") + b"c" * k
        n -= k
    return out


@pytest.mark.parametrize("seed", range(6))
def test_pillow_read_blocks_decide_arithmetic_files(tmp_path, seed):
    """Comments of 0-140,000 bytes before one scan of an arithmetic file:
    Pillow hands libjpeg the file in 64 KB blocks, a marker waits for the
    next block and an arithmetic scan cannot, so a scan that reaches past
    the blocks read by its start is refused and the others decode; the
    port decides as Pillow does."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(5):
        s = int(rng.integers(40, 160))
        px = make_textures.smooth_image(rng, s, s, float(rng.uniform(0, 40)))
        data = make_textures.jpeg_encode(
            px, quality=int(rng.integers(50, 100)), arithmetic=True,
            progressive=bool(rng.integers(0, 2)),
            restart=int(rng.choice([0, 3])))
        starts = [i for i in range(len(data) - 1)
                  if data[i:i + 2] == b"\xff\xda"]
        k = starts[int(rng.integers(0, len(starts)))]
        padded = data[:k] + _com(int(rng.integers(0, 140_000))) + data[k:]
        _same_as_jax(_write(tmp_path, padded))


REFUSED_WORDS = {
    "arithmetic_64k": r"arithmetic-coded JPEG \(SOF9\).*64 KB",
    "lossless_ycc": r"lossless JPEG in YCbCr",
    "lossless_ycck": r"lossless JPEG in YCCK",
    "lossless_restart": r"lossless JPEG whose restart interval",
    "cmyk_mcu": r"CMYK.*16 blocks an MCU",
    "440_mcu": r"4:4:0.*16 blocks an MCU",
    "411_mcu": r"4:1:1.*12 blocks an MCU",
    "fractional_h": r"3x1,2x1,1x1: fractional sampling",
    "fractional_v": r"1x3,1x2,1x1: fractional sampling",
    "12-bit": r"12-bit JPEG", "16-bit": r"16-bit JPEG",
    "two_components": r"2-component JPEG",
    "sof5": r"hierarchical JPEG \(SOF5\)",
    "sof6": r"hierarchical JPEG \(SOF6\)",
    "sof7": r"hierarchical JPEG \(SOF7\)",
    "sof11": r"lossless arithmetic-coded JPEG \(SOF11\)",
    "sof13": r"hierarchical JPEG \(SOF13\)",
    "sof14": r"hierarchical JPEG \(SOF14\)",
    "sof15": r"hierarchical JPEG \(SOF15\)",
    "dnl_height0": r"height 0 \(set by a DNL marker\)",
    "reserved_marker": r"unknown JPEG marker 0xF1"}


@pytest.mark.parametrize("case", make_textures.JPEG_REFUSED)
def test_refused_cases_name_file_and_case(tmp_path, case):
    """Each JPEG Pillow refuses raises a ValueError naming the file, the
    format and the case; JAX's loader (Pillow) refuses it too."""
    path = _write(tmp_path, make_textures.jpeg_refused(case), "t.tex")
    with pytest.raises(ValueError, match=REFUSED_WORDS[case]) as e:
        image_io.load_image(path)
    assert path in str(e.value) and "JPEG" in str(e.value)
    with pytest.raises(Exception):
        jax_image_io.load_image(path)


def test_dnl_marker_with_a_height_is_ignored(tmp_path):
    """A DNL marker after the scan of a file whose frame gives its height
    is skipped (jdmarker.c), in the port as in Pillow."""
    px = make_textures.smooth_image(np.random.default_rng(5), 17, 23, 10.0)
    data = make_textures.jpeg_encode(px)
    data = data[:-2] + b"\xff\xdc\x00\x04\x00\x11" + data[-2:]
    assert _same_as_jax(_write(tmp_path, data)) is not None
