"""JPEG textures without Pillow: the decoder of the native host library
(cge_tpu_torch/native/cge_jpeg.cpp), which decodes as libjpeg-turbo does
with the defaults Pillow runs it with, so the texels equal the JAX
package's `load_image` (Pillow's `convert("RGB")`) byte for byte.

It reads every JPEG that Pillow opens: sequential and progressive DCT with
Huffman or arithmetic coding (with DAC conditioning and restart
intervals), and sequential lossless (predictors 1 to 7, point
transforms); 8-bit samples; grey, three components (JFIF YCbCr, Adobe RGB
or YCbCr, or as the component ids say) or four (CMYK, or YCCK under an
Adobe marker of transform 2), at every whole sampling ratio; progressive
files whose scans leave a low coefficient unrefined are smoothed as
libjpeg smooths them. Entropy decoding is byte-serial, so all of it runs
in C++: the islow IDCT, the upsampling libjpeg picks for each component
and the fixed-point YCbCr -> RGB and YCCK -> CMYK tables. Four components
come out as CMYK, and Pillow's reading of them ("CMYK;I", Adobe's
inverted CMYK) and its conversion to RGB follow here, with scene/psd.py's
copy of Pillow's cmyk2rgb.

What Pillow refuses raises a ValueError that names the case: 12- and
16-bit samples, two components, hierarchical JPEG, lossless arithmetic
coding, fractional sampling ratios, a DNL marker, lossless YCbCr or YCCK,
and an arithmetic-coded scan that runs past the 64 KB blocks in which
Pillow hands the file to libjpeg (jdarith.c cannot wait for the next
block). The library is built at first use (native.library()); a failed
build raises, and nothing falls back.
"""

from __future__ import annotations

import numpy as np

from cge_tpu_torch import native
from cge_tpu_torch.scene.psd import _cmyk_to_rgb


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> [H, W, 3] uint8 RGB, row 0 the top."""
    lib = native.library()
    info = np.zeros(3, np.intc)
    native.decode_call(lib.cge_jpeg_info, data, len(data), info.ctypes.data)
    w, h, channels = (int(v) for v in info)
    native.check_pixels("JPEG", w, h)
    out = np.empty((h, w, channels), np.uint8)
    native.decode_call(lib.cge_jpeg_decode, data, len(data), out.ctypes.data,
                       out.size)
    if channels == 4:
        # Pillow: rawmode "CMYK;I" (inverted), then convert("RGB")
        return _cmyk_to_rgb(*(255 - out[..., k] for k in range(4)))
    return out
