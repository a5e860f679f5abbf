"""The native host library: OBJ loader, cluster builder and reference BVH
builder in C++ (counterpart of cge_tpu/native), and the byte-serial parts
of the texture loader.

`cge_host.cpp` is this package's own copy of the JAX package's source,
`cge_jpeg.cpp` the JPEG decoder (scene/jpeg.py, and JPEG in TIFF for
scene/tiff.py), `cge_image.cpp` the rest of the image decoding that runs
byte by byte: PNG row filters (scene/image_io.py), TGA run-length packets
(scene/tga.py), GIF LZW (scene/gif.py), PackBits (scene/psd.py and
scene/tiff.py), TIFF LZW and predictors (scene/tiff.py); `cge_webp.cpp`
the WebP bitstreams (scene/webp.py); `cge_bcn.cpp` the block-compressed
(BC1 to BC7) textures of DDS files (scene/dds.py); `cge_fax.cpp` TIFF's
CCITT fax rows and `cge_zstd.cpp` its Zstandard frames (scene/tiff.py);
`cge_raster.cpp` the run-length rows of SGI, PCX and Sun raster files, the
QOI op stream and ICNS's run-length channels (scene/sgi.py, pcx.py,
sun.py, qoi.py, icns.py); `cge_j2k.cpp` JPEG 2000 codestreams
(scene/jpeg2000.py).
Each source is compiled at first use by `g++` with the flags of the JAX
package's Makefile (CXXFLAGS, warnings as errors; cge_j2k.cpp also with
SOURCE_FLAGS' -ffp-contract=off and -fwrapv, so that its float and integer
arithmetic is OpenJPEG's) into an object of its own, all at once in
parallel, in `build/cge_tpu_torch/objects/` at the repository root, named
by a hash of the source, compiler and flags; the objects are linked into
one library named by a hash of theirs and loaded with ctypes. A change to
one source so rebuilds one object and the link; no binary is committed. A
failed build raises with the compiler's output: nothing falls back to the
numpy code or to Pillow. The numpy loader and builders (scene/mesh_io.py,
ops/bvh.py) are the library's twins and run where a caller passes
`use_native=False`; the image decoders have none (the PNG row filters'
Python twin lives in the tests).
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
JPEG_SOURCE = os.path.join(_HERE, "cge_jpeg.cpp")
WEBP_SOURCE = os.path.join(_HERE, "cge_webp.cpp")
BCN_SOURCE = os.path.join(_HERE, "cge_bcn.cpp")
FAX_SOURCE = os.path.join(_HERE, "cge_fax.cpp")
ZSTD_SOURCE = os.path.join(_HERE, "cge_zstd.cpp")
RASTER_SOURCE = os.path.join(_HERE, "cge_raster.cpp")
J2K_SOURCE = os.path.join(_HERE, "cge_j2k.cpp")
SOURCES = (SOURCE, IMAGE_SOURCE, JPEG_SOURCE, WEBP_SOURCE, BCN_SOURCE,
           FAX_SOURCE, ZSTD_SOURCE, RASTER_SOURCE, J2K_SOURCE)
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror")
# flags a source adds to CXXFLAGS, by its file name
SOURCE_FLAGS = {"cge_j2k.cpp": ("-ffp-contract=off", "-fwrapv")}

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
    "cge_jpeg_info": (_I, [ctypes.c_char_p, ctypes.c_long, _P,
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
    "cge_sgi_rle": (_I, [ctypes.c_char_p, ctypes.c_long, _I, _I, _I, _I, _P,
                         ctypes.c_char_p, _I]),
    **{name: (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                   ctypes.c_long, _I, _P, ctypes.c_char_p, _I])
       for name in ("cge_pcx_rle", "cge_sun_rle")},
    "cge_qoi": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                     ctypes.c_long, _P, ctypes.c_char_p, _I]),
    "cge_icns_rle": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                          ctypes.c_long, _P, ctypes.c_char_p, _I]),
    "cge_j2k_open": (_I, [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                          ctypes.POINTER(_P), ctypes.c_char_p, _I]),
    "cge_j2k_info": (None, [_P, _P]),
    "cge_j2k_comp": (None, [_P, _I, _P]),
    "cge_j2k_decode": (_I, [_P, ctypes.POINTER(_I), ctypes.c_char_p, _I]),
    "cge_j2k_tile": (None, [_P, _I, _P, _P]),
    "cge_j2k_free": (None, [_P]),
    "cge_j2k_idwt53": (_I, [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_char_p, _I]),
}


class HostLibrary:
    """The loaded library and what its build took: the seconds, the
    compilers' output and the sources compiled in this build (the others'
    objects were there)."""

    def __init__(self, path: str, build_seconds: float, build_log: str,
                 compiled: tuple = ()):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.compiled = compiled
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
            setattr(self, name, fn)
        self._lib = lib


def _run(cmds: list, what: str) -> str:
    """Run the commands at once; their output, or RuntimeError with it
    when one cannot start or fails."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    except OSError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"native build: cannot run {cmds[0][0]!r}: {e}") \
            from e
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(killed after 300 s)"
        logs.append(out)
        if p.returncode:
            failed.append(f"{' '.join(cmd)}:\n{out}")
    if failed:
        raise RuntimeError(f"native build failed ({what}):\n" +
                           "\n".join(failed))
    return "".join(logs)


def build(cxx: str = CXX, flags=CXXFLAGS,
          build_dir: str = _kernels.BUILD_DIR,
          sources: tuple = SOURCES) -> HostLibrary:
    """Compile each source whose object (named by the hash of the source,
    compiler and flags) is not there yet, all in parallel, link the
    objects unless a library of the same objects is there, and load it.
    RuntimeError with the compiler's output when the compiler is missing
    or fails."""
    prefix = " ".join((cxx,) + tuple(flags)).encode()
    obj_dir = os.path.join(build_dir, "objects")
    os.makedirs(obj_dir, exist_ok=True)
    objs, todo = [], []
    for src in sources:
        extra = SOURCE_FLAGS.get(os.path.basename(src), ())
        with open(src, "rb") as f:
            key = hashlib.sha256(prefix + " ".join(extra).encode() + b"\0"
                                 + f.read()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(src))[0]
        obj = os.path.join(obj_dir, f"{stem}_{key}.o")
        objs.append(obj)
        if not os.path.exists(obj):
            todo.append((src, obj, extra))
    h = hashlib.sha256(prefix + "".join(objs).encode())
    path = os.path.join(build_dir, f"libcge_host_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if todo:
        tmps = [f"{obj}.{os.getpid()}.tmp" for _, obj, _ in todo]
        try:
            log = _run([[cxx, *flags, *extra, "-c", "-o", tmp, src]
                        for (src, _, extra), tmp in zip(todo, tmps)],
                       "compiling " + ", ".join(
                           os.path.basename(s) for s, _, _ in todo))
            for (_, obj, _), tmp in zip(todo, tmps):
                os.replace(tmp, obj)      # atomic: concurrent builds agree
        finally:
            for tmp in tmps:
                if os.path.exists(tmp):
                    os.remove(tmp)
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            log += _run([[cxx, *flags, "-shared", "-o", tmp, *objs]],
                        "linking")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return HostLibrary(path, time.perf_counter() - t0, log,
                       tuple(src for src, _, _ in todo))


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


class NotOpened(ValueError):
    """A file that its format's test of the first bytes accepts but whose
    header Pillow's plugin cannot open (its _open raises SyntaxError,
    IndexError, TypeError, KeyError, EOFError or struct.error, or gives an
    empty image): Image.open then tries the formats after it in its order,
    and so does image_io.decode_image."""


def check_pixels(fmt: str, width: int, height: int) -> None:
    """ValueError for an image of more than MAX_PIXELS pixels."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{fmt} of {width}x{height} pixels: past Pillow's "
                         f"limit of {MAX_PIXELS} pixels")


def raw_rows(data: bytes, offset: int, rows: int, stride: int, used: int,
             fmt: str) -> np.ndarray:
    """The rows [rows, stride] uint8 of an uncompressed image at
    data[offset:], as Pillow's raw decoder reads them: each row's first
    `used` bytes, the padding after them skipped, so the last row's padding
    may be missing from the file (zeros here); ValueError naming fmt where
    the data end before the last row's used bytes."""
    need = (rows - 1) * stride + used if rows else 0
    if offset + need > len(data):
        have = max(0, len(data) - offset)
        raise ValueError(f"{fmt}: the image data is truncated ({have} of "
                         f"{need} bytes)")
    buf = np.zeros(rows * stride, np.uint8)
    got = np.frombuffer(data, np.uint8, min(rows * stride, len(data) - offset),
                        offset)
    buf[:len(got)] = got
    return buf.reshape(rows, stride)


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


def sgi_rle(data: bytes, width: int, height: int, bands: int,
            bpc: int) -> np.ndarray:
    """An SGI file's run-length rows (the whole file, its tables after the
    512-byte header) -> [height, width, bands * bpc] uint8 in the tables'
    row order (the image's last row first), each channel's bpc-byte atoms
    interleaved, as Pillow's SgiRleDecode gives them; zeros after a last
    packet that ends the image early; an error on an overrun."""
    out = np.zeros((height, width, bands * bpc), np.uint8)
    decode_call(library().cge_sgi_rle, data, len(data), width, height,
                bands, bpc, out.ctypes.data)
    return out


def pcx_rle(data: bytes, offset: int, row_bytes: int,
            rows: int) -> np.ndarray:
    """PCX run-length data from data[offset:] -> rows [rows, row_bytes]
    uint8, as Pillow's PcxDecode reads them: an error where a run crosses
    a row's end or the data ends first."""
    out = np.empty((rows, row_bytes), np.uint8)
    decode_call(library().cge_pcx_rle, data, len(data), offset, row_bytes,
                rows, out.ctypes.data)
    return out


def sun_rle(data: bytes, offset: int, row_bytes: int,
            rows: int) -> np.ndarray:
    """Sun raster run-length data from data[offset:] -> rows [rows,
    row_bytes] uint8, as Pillow's SunRleDecode reads them (runs flow on
    across rows); an error where the data ends first."""
    out = np.empty((rows, row_bytes), np.uint8)
    decode_call(library().cge_sun_rle, data, len(data), offset, row_bytes,
                rows, out.ctypes.data)
    return out


def qoi(data: bytes, offset: int, pixels: int) -> np.ndarray:
    """A QOI op stream from data[offset:] -> [pixels, 4] uint8 RGBA, as
    Pillow's QoiDecoder gives them; an error where the stream ends before
    the last pixel."""
    out = np.empty((pixels, 4), np.uint8)
    decode_call(library().cge_qoi, data, len(data), offset, pixels,
                out.ctypes.data)
    return out


def icns_rle(data: bytes, offset: int, pixels: int) -> np.ndarray:
    """An ICNS run-length colour entry from data[offset:] -> [pixels, 3]
    uint8 RGB, as Pillow's
    IcnsImagePlugin.read_32 reads it: channel after channel, a byte b >=
    0x80 repeating the next byte b - 125 times, any other b + 1 literal
    bytes; an error where a channel's runs overrun its pixels or the data
    end first."""
    out = np.zeros((3, pixels), np.uint8)
    decode_call(library().cge_icns_rle, data, len(data), offset, pixels,
                out.ctypes.data)
    return np.ascontiguousarray(out.T)


class J2k:
    """A JPEG 2000 codestream at data[start:] (data: the whole file, whose
    end is the stream's end, as OpenJPEG is given it) opened by
    cge_j2k.cpp: its main header read (ValueError where OpenJPEG's reading
    fails); x0, y0, x1, y1 its image area on the reference grid and comps
    each component's (precision, signed, dx, dy). tiles() decodes every
    tile: [(index, (x0, y0, x1, y1), [int32 [h, w] samples of each
    component])] in the order OpenJPEG hands them to Pillow. A context
    manager: the decoder is released on exit."""

    def __init__(self, data: bytes, start: int = 0):
        self._lib = library()
        self._data = data
        handle = _P()
        decode_call(self._lib.cge_j2k_open, data, len(data), start,
                    ctypes.byref(handle))
        self._handle = handle
        info = np.zeros(8, np.int64)
        self._lib.cge_j2k_info(handle, info.ctypes.data)
        self.x0, self.y0, self.x1, self.y1 = (int(v) for v in info[:4])
        self.comps = []
        for c in range(int(info[4])):
            self._lib.cge_j2k_comp(handle, c, info.ctypes.data)
            self.comps.append((int(info[0]), bool(info[1]), int(info[2]),
                               int(info[3])))

    def tiles(self) -> list:
        count = _I()
        decode_call(self._lib.cge_j2k_decode, self._handle,
                    ctypes.byref(count))
        out = []
        nc = len(self.comps)
        box = np.zeros(5 + 4 * nc, np.int64)
        for k in range(count.value):
            self._lib.cge_j2k_tile(self._handle, k, box.ctypes.data, None)
            planes = [np.empty((max(0, int(y1 - y0)), max(0, int(x1 - x0))),
                               np.int32)
                      for x0, y0, x1, y1 in box[5:].reshape(nc, 4)]
            ptrs = (_P * nc)(*(p.ctypes.data for p in planes))
            self._lib.cge_j2k_tile(self._handle, k, box.ctypes.data, ptrs)
            out.append((int(box[0]), tuple(int(v) for v in box[1:5]),
                        planes))
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.cge_j2k_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def j2k_idwt53(coef: np.ndarray, x0: int, y0: int, low: tuple,
               rct: bool = False) -> np.ndarray:
    """One level of the decoder's inverse 5/3 transform on int32 planes
    coef [P, h, w] (each holding its low band's low[1] x low[0] samples top
    left, then the high bands, as the decoder lays them out) of a
    resolution whose top-left sample is (x0, y0) on its grid; then, with
    rct, the reversible component transform of the three planes. A copy."""
    out = np.ascontiguousarray(coef, np.int32).copy()
    p, h, w = out.shape
    decode_call(library().cge_j2k_idwt53, out.ctypes.data, w, h, x0, y0,
                low[0], low[1], p, int(rct))
    return out
