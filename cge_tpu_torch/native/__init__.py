"""The native host library: OBJ loader, cluster builder and reference BVH
builder in C++ (counterpart of cge_tpu/native), and the byte-serial parts
of the texture loader.

`cge_host.cpp` is this package's own copy of the JAX package's source,
`cge_image.cpp` the port's image decoding that runs byte by byte: JPEG
(scene/jpeg.py), PNG row filters (scene/image_io.py), TGA run-length
packets (scene/tga.py), GIF LZW (scene/gif.py), PackBits (scene/psd.py and
scene/tiff.py), TIFF LZW and predictors (scene/tiff.py);
`cge_webp.cpp` the WebP bitstreams (scene/webp.py); `cge_bcn.cpp` the
block-compressed (BC1 to BC7) textures of DDS files (scene/dds.py);
`cge_fax.cpp` TIFF's CCITT fax rows and `cge_zstd.cpp` its Zstandard
frames (scene/tiff.py, which also reads JPEG in TIFF through
cge_image.cpp's decoder). All are compiled at
first use by `g++` with the flags of
the JAX package's Makefile (CXXFLAGS, warnings as errors) into one library
in `build/cge_tpu_torch/` at the repository root, named by a hash of the
sources, compiler and flags, and loaded with ctypes; no binary is
committed. A failed build raises with the compiler's output: nothing falls
back to the numpy code or to Pillow. The numpy loader and builders
(scene/mesh_io.py, ops/bvh.py) are the library's twins and run where a
caller passes `use_native=False`; the image decoders have none (the PNG
row filters' Python twin lives in the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

from cge_tpu_torch import _kernels

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "cge_host.cpp")
IMAGE_SOURCE = os.path.join(_HERE, "cge_image.cpp")
WEBP_SOURCE = os.path.join(_HERE, "cge_webp.cpp")
BCN_SOURCE = os.path.join(_HERE, "cge_bcn.cpp")
FAX_SOURCE = os.path.join(_HERE, "cge_fax.cpp")
ZSTD_SOURCE = os.path.join(_HERE, "cge_zstd.cpp")
SOURCES = (SOURCE, IMAGE_SOURCE, WEBP_SOURCE, BCN_SOURCE, FAX_SOURCE,
           ZSTD_SOURCE)
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name: (restype, argtypes)
_SIGNATURES = {
    "cge_load_obj": (_P, [ctypes.c_char_p, _I]),
    "cge_error": (ctypes.c_char_p, [_P]),
    "cge_n_submeshes": (_I, [_P]),
    "cge_submesh_counts": (None, [_P, _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I)]),
    "cge_submesh_data": (None, [_P, _I, _P, _P, _P, _P]),
    "cge_submesh_material": (_I, [_P, _I, _P, ctypes.c_char_p, _I]),
    "cge_release": (None, [_P]),
    "cge_build_clusters": (_I, [_P, _I, _I, _P, _I]),
    "cge_build_bvh": (_I, [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]),
    "cge_jpeg_info": (_I, [ctypes.c_char_p, ctypes.c_long,
                           ctypes.POINTER(_I), ctypes.POINTER(_I),
                           ctypes.c_char_p, _I]),
    "cge_jpeg_decode": (_I, [ctypes.c_char_p, ctypes.c_long, _P,
                             ctypes.c_long, ctypes.c_char_p, _I]),
    "cge_png_unfilter": (_I, [ctypes.c_char_p, ctypes.c_long, _I,
                              ctypes.c_long, _I, _P, ctypes.c_char_p, _I]),
    "cge_tga_rle": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _I,
                         ctypes.c_long, _I, _P, ctypes.c_char_p, _I]),
    "cge_packbits": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                          ctypes.c_long, _I, _P, ctypes.c_char_p, _I]),
    "cge_gif_lzw": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _I,
                         _I, _I, _I, _P, ctypes.c_char_p, _I]),
    "cge_tiff_lzw": (_I, [ctypes.c_char_p, ctypes.c_long, _P, ctypes.c_long,
                          ctypes.c_char_p, _I]),
    "cge_tiff_predict": (_I, [_P, _I, ctypes.c_long, _I, _I, _I, _I,
                              ctypes.c_char_p, _I]),
    **{name: (_I, [ctypes.c_char_p, ctypes.c_long, _I, _I, _P,
                   ctypes.c_char_p, _I])
       for name in ("cge_webp_vp8", "cge_webp_vp8l", "cge_webp_alph")},
    "cge_bcn_decode": (_I, [ctypes.c_char_p, ctypes.c_long, _I, _I, _I, _I,
                            _P, ctypes.c_char_p, _I]),
    **{name: (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                   ctypes.c_long, _I, _P, *rest])
       for name, rest in (
           ("cge_jpeg_tiff_info", [ctypes.c_char_p, _I]),
           ("cge_jpeg_tiff_decode", [ctypes.c_long, ctypes.c_char_p, _I]))},
    "cge_fax_decode": (_I, [ctypes.c_char_p, _P, _P, _I, _I, _I, _I, _P, _P,
                            _P, ctypes.c_char_p, _I]),
    "cge_zstd_decode": (_I, [ctypes.c_char_p, ctypes.c_long, _P,
                             ctypes.c_long, _P, ctypes.c_char_p, _I]),
}


class HostLibrary:
    """The loaded library and what its build took."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
            setattr(self, name, fn)
        self._lib = lib


def build(cxx: str = CXX, flags=CXXFLAGS,
          build_dir: str = _kernels.BUILD_DIR) -> HostLibrary:
    """Compile the sources (unless a build of the same sources, compiler
    and flags is there) and load the library. RuntimeError with the
    compiler's output when the compiler is missing or fails."""
    h = hashlib.sha256(" ".join((cxx,) + tuple(flags)).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"libcge_host_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *flags, "-shared", "-o", tmp, *SOURCES]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except OSError as e:
            raise RuntimeError(f"native build: cannot run {cxx!r}: {e}") \
                from e
        log = r.stdout + r.stderr
        if r.returncode:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                               f"{log}")
        os.replace(tmp, path)     # atomic: concurrent builds agree
    return HostLibrary(path, time.perf_counter() - t0, log)


_LIBRARY: HostLibrary | None = None


def library() -> HostLibrary:
    """The default build, built once per process at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY


def load_obj(path: str, center_and_normalize: bool) -> list:
    """The native loadMesh: [(positions [V, 3] f32, normals [V, 3] f32,
    texcoords [V, 2] f32, triangles [T, 3] u32, material dict)] per
    sub-mesh; the dict holds kd, ks, shininess, dissolve, map_kd (None
    when absent) and default. FileNotFoundError for a missing file."""
    lib = library()
    h = lib.cge_load_obj(os.fsencode(path), int(center_and_normalize))
    if not h:
        raise RuntimeError(f"native loader returned no result for {path}")
    try:
        err = lib.cge_error(h)
        if err:
            raise FileNotFoundError(f"{err.decode()}: {path}")
        out = []
        for i in range(lib.cge_n_submeshes(h)):
            nv, nt = _I(), _I()
            lib.cge_submesh_counts(h, i, ctypes.byref(nv), ctypes.byref(nt))
            pos = np.empty((nv.value, 3), np.float32)
            nrm = np.empty((nv.value, 3), np.float32)
            uv = np.empty((nv.value, 2), np.float32)
            tris = np.empty((nt.value, 3), np.uint32)
            lib.cge_submesh_data(h, i, pos.ctypes.data, nrm.ctypes.data,
                                 uv.ctypes.data, tris.ctypes.data)
            mat8 = np.empty(8, np.float32)
            map_kd = ctypes.create_string_buffer(4096)
            default = lib.cge_submesh_material(h, i, mat8.ctypes.data,
                                               map_kd, 4096)
            out.append((pos, nrm, uv, tris, dict(
                kd=mat8[:3].copy(), ks=mat8[3:6].copy(),
                shininess=float(mat8[6]), dissolve=float(mat8[7]),
                map_kd=map_kd.value.decode() or None,
                default=bool(default))))
        return out
    finally:
        lib.cge_release(h)


def build_clusters(centers: np.ndarray, cluster_size: int) -> np.ndarray:
    """Largest-extent median clusters of the [N, 3] centres: [L,
    cluster_size] i32 positions into centers, -1 padded."""
    lib = library()
    centers = np.ascontiguousarray(centers, np.float32)
    n = len(centers)
    cap = max(1, 2 * (n // cluster_size + 1)) * cluster_size
    perm = np.empty(cap, np.int32)
    nc = lib.cge_build_clusters(centers.ctypes.data, n, cluster_size,
                                perm.ctypes.data, cap)
    if nc < 0:
        raise RuntimeError(f"native cluster build of {n} centres overran "
                           f"its {cap} slots")
    return perm[: nc * cluster_size].reshape(nc, cluster_size).copy()


def build_bvh(lo: np.ndarray, hi: np.ndarray, centers: np.ndarray,
              sah: bool):
    """The reference-parity BVH of N primitive boxes and centres: (node_lo
    [K, 3], node_hi [K, 3], node_meta [K, 6] i32, perm [N] i32, (levels,
    leaves, max_per_leaf)); the root is the last node."""
    lib = library()
    lo, hi, centers = (np.ascontiguousarray(x, np.float32)
                       for x in (lo, hi, centers))
    n = len(centers)
    cap = max(1, 2 * n - 1)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 6), np.int32)
    perm = np.empty(n, np.int32)
    stats = np.empty(3, np.int32)
    count = lib.cge_build_bvh(lo.ctypes.data, hi.ctypes.data,
                              centers.ctypes.data, n, int(sah), cap,
                              node_lo.ctypes.data, node_hi.ctypes.data,
                              node_meta.ctypes.data, perm.ctypes.data,
                              stats.ctypes.data)
    if count < 0:
        raise RuntimeError(f"native BVH build of {n} primitives failed")
    return (node_lo[:count].copy(), node_hi[:count].copy(),
            node_meta[:count].copy(), perm,
            (int(stats[0]), int(stats[1]), int(stats[2])))


# Pillow's decompression-bomb limit (twice Image.MAX_IMAGE_PIXELS), past
# which its Image.open refuses an image: the decoders refuse such an image
# before they allocate it
MAX_PIXELS = 2 * 89478485


def check_pixels(fmt: str, width: int, height: int) -> None:
    """ValueError for an image of more than MAX_PIXELS pixels."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{fmt} of {width}x{height} pixels: past Pillow's "
                         f"limit of {MAX_PIXELS} pixels")


def decode_call(fn, *args) -> None:
    """Call an image entry point of the library; ValueError with its
    message when it fails."""
    err = ctypes.create_string_buffer(512)
    if fn(*args, err, len(err)):
        raise ValueError(err.value.decode())


def png_unfilter(raw: bytes, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """PNG scanlines [height, 1 + stride] (filter byte first) -> the rows
    [height, stride] uint8 with each filter undone (PNG spec section 9)."""
    out = np.empty((height, stride), np.uint8)
    decode_call(library().cge_png_unfilter, raw, len(raw), height, stride,
                bpp, out.ctypes.data)
    return out


def tga_rle(data: bytes, offset: int, depth: int, row_bytes: int,
            rows: int) -> np.ndarray:
    """TGA run-length packets of depth-byte pixels from data[offset:] ->
    rows [rows, row_bytes] uint8 in the file's order, as Pillow reads them:
    a literal packet flows on into the next row, a run packet must end in
    its row."""
    out = np.empty((rows, row_bytes), np.uint8)
    decode_call(library().cge_tga_rle, data, len(data), offset, depth,
                row_bytes, rows, out.ctypes.data)
    return out


def packbits(data: bytes, offset: int, row_bytes: int, rows: int,
             partial: bool = False) -> np.ndarray:
    """PackBits rows from data[offset:] -> [rows, row_bytes] uint8, as
    Pillow reads them: a packet that runs past its row's end is cut; an
    error where the data ends first, or with partial the packets that
    were whole, zeros after."""
    out = np.zeros((rows, row_bytes), np.uint8)
    try:
        decode_call(library().cge_packbits, data, len(data), offset,
                    row_bytes, rows, out.ctypes.data)
    except ValueError:
        if not partial:
            raise
    return out


def gif_lzw(data: bytes, offset: int, bits: int, out: np.ndarray,
            interlace: bool) -> None:
    """Decode a GIF image's LZW sub-blocks from data[offset:] (just past
    its minimum code size `bits`) into out [h, w] uint8 in place: rows in
    order or in the four interlaced passes, up to the last pixel (a stream
    that ends before it is an error, as in Pillow)."""
    if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError("gif_lzw writes into a C-contiguous uint8 [h, w] "
                         "array")
    h, w = out.shape
    decode_call(library().cge_gif_lzw, data, len(data), offset, bits, w,
                h, int(interlace), out.ctypes.data)


def tiff_lzw(data: bytes, size: int, partial: bool = False) -> np.ndarray:
    """A TIFF strip's or tile's LZW codes -> its first size bytes, as
    libtiff decodes them (new- or old-style codes); an error where the
    codes end first, or with partial what was decoded, zeros after."""
    out = np.zeros(size, np.uint8)
    try:
        decode_call(library().cge_tiff_lzw, data, len(data),
                    out.ctypes.data, size)
    except ValueError:
        if not partial:
            raise
    return out


def tiff_predict(buf: np.ndarray, rows: int, bits: int, stride: int,
                 predictor: int, big_endian: bool) -> None:
    """Undo TIFF predictor 2 or 3 in place on buf (uint8 rows [rows,
    row_bytes]), as libtiff does; the samples come out little-endian."""
    if buf.dtype != np.uint8 or buf.ndim != 2 or not buf.flags.c_contiguous:
        raise ValueError("tiff_predict works on a C-contiguous uint8 "
                         "[rows, row_bytes] array")
    decode_call(library().cge_tiff_predict, buf.ctypes.data, rows,
                buf.shape[1], bits, stride, predictor, int(big_endian))


def webp(kind: str, data: bytes, rgba: np.ndarray) -> None:
    """Decode a WebP chunk's payload of kind "vp8" (a lossy key frame,
    through libwebp's fancy upsampling to RGBA, alpha 255), "vp8l" (a
    lossless image) or "alph" (an alpha plane, into the alpha bytes only)
    into rgba [h, w, 4] uint8 in place, its size the frame's."""
    if (rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4
            or not rgba.flags.c_contiguous):
        raise ValueError("the WebP decoders write into a C-contiguous uint8 "
                         "[h, w, 4] array")
    decode_call(getattr(library(), f"cge_webp_{kind}"), data, len(data),
                rgba.shape[1], rgba.shape[0], rgba.ctypes.data)


def bcn(data: bytes, kind: int, signed: bool, rgba: np.ndarray) -> None:
    """Decode a grid of BCn blocks (kind 1 to 7: BC1 to BC7, signed for
    BC5 and BC6H) from the start of data into rgba [4 * blocks_h,
    4 * blocks_w, 4] uint8 in place, as Pillow's BCn decoder gives the
    pixels; an error where data holds fewer bytes than the grid."""
    if (rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4
            or rgba.shape[0] % 4 or rgba.shape[1] % 4
            or not rgba.flags.c_contiguous):
        raise ValueError("the BCn decoder writes into a C-contiguous uint8 "
                         "[4 * blocks_h, 4 * blocks_w, 4] array")
    decode_call(library().cge_bcn_decode, data, len(data), kind,
                int(signed), rgba.shape[1] // 4, rgba.shape[0] // 4,
                rgba.ctypes.data)


def jpeg_tiff_info(tables: bytes, data: bytes, color: int) -> tuple:
    """A TIFF strip's or tile's JPEG stream (compression 7), read after the
    tables-only stream `tables` (JPEGTables; b"" for none) in the colour
    space the TIFF sets (color 0: none, 1: YCbCr -> RGB): (width, height,
    components, the first component's h and v sampling, whether the
    others are 1x1)."""
    info = np.zeros(6, np.intc)
    decode_call(library().cge_jpeg_tiff_info, tables, len(tables), data,
                len(data), color, info.ctypes.data)
    return tuple(int(v) for v in info)


def jpeg_tiff(tables: bytes, data: bytes, color: int) -> np.ndarray:
    """That stream's samples: [height, width, components] uint8 (3, RGB,
    at color 1)."""
    w, h, nc = jpeg_tiff_info(tables, data, color)[:3]
    out = np.empty((h, w, 3 if color == 1 else nc), np.uint8)
    decode_call(library().cge_jpeg_tiff_decode, tables, len(tables), data,
                len(data), color, out.ctypes.data, out.size)
    return out


def fax(chunks: list, comp: int, options: int, width: int, rows: list,
        events: np.ndarray | None = None) -> np.ndarray:
    """The CCITT chunks (each strip's or tile's bytes, FillOrder already
    undone) of one image, compression comp (2, 3 or 4) with T4Options
    `options`, `rows[i]` rows of `width` pixels each -> their rows one
    after another, [sum(rows), ceil(width / 8)] uint8, 1 bits black runs;
    events, where given (int64 [6]), receives the decoder's counts (see
    cge_fax.cpp)."""
    data = b"".join(chunks)
    sizes = np.array([len(c) for c in chunks], np.int_)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int_)
    n_rows = np.array(rows, np.intc)
    out = np.zeros((int(n_rows.sum()), (width + 7) // 8), np.uint8)
    ev = np.zeros(6, np.int64)
    decode_call(library().cge_fax_decode, data, starts.ctypes.data,
                sizes.ctypes.data, len(chunks), comp, options, width,
                n_rows.ctypes.data, out.ctypes.data, ev.ctypes.data)
    if events is not None:
        events[:] = ev
    return out


def zstd(data: bytes, size: int, stats: np.ndarray | None = None
         ) -> np.ndarray:
    """A TIFF strip's or tile's ZSTD frame -> its first size bytes, as
    libtiff streams it through libzstd: an error where the first frame
    ends, or the data does, before size bytes; stats, where given (int64
    [25]), receives the decoder's counts of literal, table and block kinds
    (see cge_zstd.cpp), also when it fails."""
    out = np.empty(size, np.uint8)
    st = np.zeros(25, np.int64)
    try:
        decode_call(library().cge_zstd_decode, data, len(data),
                    out.ctypes.data, size, st.ctypes.data)
    finally:
        if stats is not None:
            stats[:] = st
    return out
