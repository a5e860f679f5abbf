"""The port's PNG decoder (cge_tpu_torch/scene/image_io.py) against Pillow,
which the JAX package's loader uses: seeded numpy images of every colour
type, every row filter and odd sizes, written by the port's `write_png`
and by Pillow; pixels must be equal exactly (u8 / 255 as float32, as
stb_image and the JAX loader give them)."""

import numpy as np
import pytest
from PIL import Image as PIL

from cge_tpu_torch.scene import image_io, mesh_io

# samples a pixel -> the colour type write_png gives it
COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}


def _pillow_rgb(path):
    with PIL.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_each_colour_type_and_filter_matches_pillow(tmp_path, ch, filt):
    """Rows filtered with one filter type, or cycling through all five."""
    rng = np.random.default_rng(ch * 10 + (filt if isinstance(filt, int)
                                           else 9))
    px = rng.integers(0, 256, (13, 7, ch), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, px if ch > 1 else px[..., 0],
                       filters=filt if isinstance(filt, tuple) else (filt,))
    with open(path, "rb") as f:
        assert f.read(26)[25] == COLOUR[ch]
    img = image_io.load_image(path)
    want = _pillow_rgb(path)
    assert (img.width, img.height) == (7, 13)
    assert img.pixels.dtype == np.float32
    np.testing.assert_array_equal(img.pixels,
                                  want.astype(np.float32) / 255.0)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 17), (31, 2), (64, 96)])
def test_palette_images_match_pillow(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    palette = rng.integers(0, 256, (23, 3), dtype=np.uint8)
    idx = rng.integers(0, 23, (h, w), dtype=np.uint8)
    path = str(tmp_path / "p.png")
    image_io.write_png(path, idx, filters=(0, 1, 2, 3, 4), palette=palette)
    np.testing.assert_array_equal(
        image_io.decode_png(open(path, "rb").read()), _pillow_rgb(path))
    np.testing.assert_array_equal(_pillow_rgb(path), palette[idx])


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_pillow_written_files_decode(tmp_path, mode):
    """Files Pillow writes, with its own filter choices."""
    rng = np.random.default_rng(len(mode))
    im = PIL.fromarray(rng.integers(0, 256, (29, 33, 3), dtype=np.uint8))
    path = str(tmp_path / f"{mode}.png")
    im.convert(mode).save(path)
    np.testing.assert_array_equal(
        image_io.decode_png(open(path, "rb").read()), _pillow_rgb(path))


def test_write_png_round_trips(tmp_path):
    """Float radiance is quantised as the image writer does (to_u8: NaN ->
    0, clamp, x255, truncate), then reads back exactly."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    img[0, 0, 1] = np.nan
    path = str(tmp_path / "r.png")
    image_io.write_png(path, img, filters=(4, 3))
    back = image_io.load_image(path).pixels
    u8 = image_io.to_u8(img)
    np.testing.assert_array_equal(back, u8.astype(np.float32) / 255.0)
    assert u8[0, 0, 1] == 0 and back.shape == (9, 11, 3)


def _header(path, depth, ctype, interlace):
    import struct
    import zlib

    body = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
    chunk = (struct.pack(">I", 13) + b"IHDR" + body
             + struct.pack(">I", zlib.crc32(b"IHDR" + body)))
    with open(path, "wb") as f:
        f.write(image_io.SIGNATURE + chunk)


@pytest.mark.parametrize("depth,ctype,interlace,words", [
    (16, 2, 0, "16-bit RGB PNG"), (16, 0, 0, "16-bit grey PNG"),
    (8, 6, 1, "interlaced (Adam7) 8-bit RGBA PNG"),
    (4, 3, 0, "4-bit palette PNG")])
def test_unsupported_pngs_name_their_format(tmp_path, depth, ctype,
                                            interlace, words):
    path = str(tmp_path / "x.png")
    _header(path, depth, ctype, interlace)
    with pytest.raises(ValueError, match=words.replace("(", r"\(")
                       .replace(")", r"\)")):
        image_io.load_image(path)


def test_loader_decodes_png_without_pillow(tmp_path, monkeypatch):
    """The mesh loader's texture path: PNG through image_io even when PIL
    cannot be imported; another format then raises naming it."""
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    png = str(tmp_path / "t.png")
    image_io.write_png(png, px, filters=(1, 4))
    bmp = str(tmp_path / "t.bmp")
    PIL.fromarray(px).save(bmp)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = mesh_io.load_image(png)
    np.testing.assert_array_equal(img.pixels, px.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match=r"\.bmp"):
        mesh_io.load_image(bmp)
    monkeypatch.setattr(builtins, "__import__", real)
    np.testing.assert_array_equal(mesh_io.load_image(bmp).pixels,
                                  img.pixels)


def test_not_a_png_raises(tmp_path):
    path = tmp_path / "n.png"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.load_image(str(path))
