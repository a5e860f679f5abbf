"""JPEG textures without Pillow: the decoder of the native host library
(cge_tpu_torch/native/cge_image.cpp), which decodes as libjpeg-turbo does
with the defaults Pillow runs it with, so the texels equal the JAX
package's `load_image` (Pillow's `convert("RGB")`) byte for byte.

It reads baseline and progressive Huffman JPEG with 8-bit samples, grey or
three components at 4:4:4, 4:2:2 or 4:2:0, with or without restart
intervals, as JFIF YCbCr or Adobe RGB / YCbCr: the islow IDCT, fancy
upsampling and the fixed-point YCbCr -> RGB tables. Entropy decoding is
byte-serial, so all of it runs in C++. Arithmetic coding, lossless,
hierarchical and 12-bit JPEG, CMYK / YCCK and other samplings raise a
ValueError that names the format. The library is built at first use
(native.library()); a failed build raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cge_tpu_torch import native


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> [H, W, 3] uint8 RGB, row 0 the top."""
    lib = native.library()
    w, h = ctypes.c_int(), ctypes.c_int()
    native.decode_call(lib.cge_jpeg_info, data, len(data), ctypes.byref(w),
                    ctypes.byref(h))
    out = np.empty((h.value, w.value, 3), np.uint8)
    native.decode_call(lib.cge_jpeg_decode, data, len(data), out.ctypes.data,
                    out.size)
    return out
