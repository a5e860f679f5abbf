"""JPEGs that Pillow's save does not write, through Pillow's own
libjpeg-turbo compressor (pillow.libs/libjpeg-*.so) driven with ctypes:
any sampling factors, colour space (grey, RGB, YCbCr, CMYK, YCCK, or none
for two components), arithmetic coding with its DAC conditioning, scan
scripts, restart intervals and lossless mode (jpeg_enable_lossless). The
JAX side of the port's texture tests uses it to write JPEG fixtures
(make_textures.py) and test-time files.

libjpeg's error manager calls exit() on an error, and a ctypes callback
cannot unwind libjpeg's stack. So the compressor runs in a worker process
of its own (`python3 jax_references/jpeg_encoder.py`, started at the first
call and kept), whose error_exit sends libjpeg's message and ends the
worker; `jpeg_encode` then raises ValueError and the next call starts a
new worker. Requests and answers are pickles between this module and its
worker.
"""

from __future__ import annotations

import ctypes
import glob
import os
import pickle
import struct
import subprocess
import sys

import numpy as np

# J_COLOR_SPACE (jpeglib.h)
JCS = {"unknown": 0, "grey": 1, "rgb": 2, "ycc": 3, "cmyk": 4, "ycck": 5}
# components of the input -> its colour space
_INPUT = {1: "grey", 2: "unknown", 3: "rgb", 4: "cmyk"}

P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
U8 = ctypes.c_uint8


class Component(ctypes.Structure):
    """jpeg_component_info's leading fields (96 bytes in all)."""
    _fields_ = [("component_id", I), ("component_index", I),
                ("h_samp_factor", I), ("v_samp_factor", I),
                ("quant_tbl_no", I), ("dc_tbl_no", I), ("ac_tbl_no", I),
                ("rest", ctypes.c_char * 68)]


class Scan(ctypes.Structure):
    """jpeg_scan_info."""
    _fields_ = [("comps_in_scan", I), ("component_index", I * 4),
                ("Ss", I), ("Se", I), ("Ah", I), ("Al", I)]


class Compress(ctypes.Structure):
    """jpeg_compress_struct of the libjpeg 6.2 ABI (520 bytes on x86-64:
    jpeg_CreateCompress checks the size), its fields up to
    write_Adobe_marker."""
    _fields_ = [("err", P), ("mem", P), ("progress", P),
                ("client_data", P), ("is_decompressor", I),
                ("global_state", I), ("dest", P), ("image_width", U),
                ("image_height", U), ("input_components", I),
                ("in_color_space", I), ("input_gamma", ctypes.c_double),
                ("data_precision", I), ("num_components", I),
                ("jpeg_color_space", I),
                ("comp_info", ctypes.POINTER(Component)),
                ("quant_tbl_ptrs", P * 4), ("dc_huff_tbl_ptrs", P * 4),
                ("ac_huff_tbl_ptrs", P * 4), ("arith_dc_L", U8 * 16),
                ("arith_dc_U", U8 * 16), ("arith_ac_K", U8 * 16),
                ("num_scans", I), ("scan_info", P),
                ("raw_data_in", I), ("arith_code", I),
                ("optimize_coding", I), ("CCIR601_sampling", I),
                ("smoothing_factor", I), ("dct_method", I),
                ("restart_interval", U), ("restart_in_rows", I),
                ("write_JFIF_header", I), ("JFIF_version", U8 * 2),
                ("density_unit", U8), ("density", ctypes.c_uint16 * 2),
                ("write_Adobe_marker", I), ("rest", ctypes.c_char * 216)]


assert ctypes.sizeof(Compress) == 520
assert Compress.arith_code.offset == 260
assert Compress.write_Adobe_marker.offset == 300
assert ctypes.sizeof(Component) == 96 and ctypes.sizeof(Scan) == 36


def _libjpeg():
    """Pillow's own libjpeg-turbo, loaded with ctypes."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs", "libjpeg-*.so*")
    lib = ctypes.CDLL(sorted(glob.glob(libs))[0])
    lib.jpeg_std_error.restype = ctypes.c_void_p
    return lib


def _compress(lib, out, px: np.ndarray, *, colorspace=None, quality=75,
              sampling=None, arithmetic=False, scans=None,
              progressive=False, restart=0, restart_rows=0,
              conditioning=None, lossless=None, adobe=None,
              tables=None) -> bytes:
    """One file, in the worker; `out` receives libjpeg's message before
    the worker ends on an error."""
    h, w, c = px.shape
    err = ctypes.create_string_buffer(168)       # jpeg_error_mgr
    cinfo = Compress()
    cinfo.err = lib.jpeg_std_error(err)

    def error_exit(ptr):
        msg = ctypes.create_string_buffer(200)
        fmt = ctypes.cast(ctypes.c_void_p.from_buffer(err, 24),
                          ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                                           ctypes.c_char_p))
        fmt(ptr, msg)                             # format_message
        _answer(out, b"E", msg.value)
        os._exit(1)

    hooks = (ctypes.CFUNCTYPE(None, ctypes.c_void_p)(error_exit),
             ctypes.CFUNCTYPE(None, ctypes.c_void_p)(lambda ptr: None))
    for offset, hook in zip((0, 16), hooks):      # error_exit, output_message
        ctypes.c_void_p.from_buffer(err, offset).value = ctypes.cast(
            hook, ctypes.c_void_p).value
    ref = ctypes.byref(cinfo)
    lib.jpeg_CreateCompress(ref, 62, ctypes.sizeof(cinfo))
    outbuf, outsize = ctypes.c_void_p(), ctypes.c_ulong()
    lib.jpeg_mem_dest(ref, ctypes.byref(outbuf), ctypes.byref(outsize))
    cinfo.image_width, cinfo.image_height = w, h
    cinfo.input_components = c
    cinfo.in_color_space = JCS[_INPUT[c]]
    lib.jpeg_set_defaults(ref)
    if colorspace is not None:
        lib.jpeg_set_colorspace(ref, JCS[colorspace])
    lib.jpeg_set_quality(ref, quality, 1)
    comps = cinfo.comp_info
    for i, (hs, vs) in enumerate(sampling or ()):
        comps[i].h_samp_factor, comps[i].v_samp_factor = hs, vs
    for i, (dc, ac) in enumerate(tables or ()):
        comps[i].dc_tbl_no, comps[i].ac_tbl_no = dc, ac
    cinfo.arith_code = int(arithmetic)
    for k, (lo, hi, kx) in (conditioning or {}).items():
        cinfo.arith_dc_L[k], cinfo.arith_dc_U[k] = lo, hi
        cinfo.arith_ac_K[k] = kx
    cinfo.restart_interval = restart
    cinfo.restart_in_rows = restart_rows
    if adobe is not None:
        cinfo.write_Adobe_marker = int(adobe)
    if scans is not None:
        script = (Scan * len(scans))()
        for sc, (idx, ss, se, ah, al) in zip(script, scans):
            sc.comps_in_scan = len(idx)
            for j, k in enumerate(idx):
                sc.component_index[j] = k
            sc.Ss, sc.Se, sc.Ah, sc.Al = ss, se, ah, al
        cinfo.num_scans = len(scans)
        cinfo.scan_info = ctypes.cast(script, ctypes.c_void_p)
    elif progressive:
        lib.jpeg_simple_progression(ref)
    if lossless is not None:
        lib.jpeg_enable_lossless(ref, *lossless)
    lib.jpeg_start_compress(ref, 1)
    rows = (ctypes.c_void_p * h)(*(px.ctypes.data + y * w * c
                                   for y in range(h)))
    lib.jpeg_write_scanlines(ref, rows, h)
    lib.jpeg_finish_compress(ref)
    data = ctypes.string_at(outbuf, outsize.value)
    lib.jpeg_destroy_compress(ref)
    ctypes.CDLL(None).free(outbuf)
    return data


def _answer(stream, kind: bytes, payload: bytes) -> None:
    stream.write(kind + struct.pack("<Q", len(payload)) + payload)
    stream.flush()


def _read(stream, n: int) -> bytes:
    data = stream.read(n)
    if len(data) != n:
        raise EOFError
    return data


def serve() -> None:
    """The worker: (px, settings) pickles in, out b"K" and the file, b"E"
    and libjpeg's message (the worker then ends), or b"P" and a Python
    error's, until its input ends."""
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    lib = _libjpeg()
    while True:
        try:
            n = struct.unpack("<Q", _read(inp, 8))[0]
        except EOFError:
            return
        px, settings = pickle.loads(_read(inp, n))
        try:
            data = _compress(lib, out, px, **settings)
        except (TypeError, KeyError, ValueError) as e:
            _answer(out, b"P", repr(e).encode())
        else:
            _answer(out, b"K", data)


_WORKER: subprocess.Popen | None = None


def jpeg_encode(px: np.ndarray, **settings) -> bytes:
    """px [h, w, c] u8 (c: 1 grey, 2 no colour space, 3 RGB, 4 CMYK)
    through libjpeg-turbo's compressor: the file's bytes.

    settings: colorspace, the JPEG colour space ("grey", "rgb", "ycc",
    "cmyk", "ycck"; jpeg_set_colorspace; by default libjpeg's for the
    input); quality; sampling, (h, v) of each component; arithmetic
    (arith_code); scans, a scan script of (component indices, Ss, Se, Ah,
    Al), or progressive for jpeg_simple_progression's; restart, the
    restart interval in MCUs, or restart_rows in MCU rows; conditioning,
    {table: (L, U, Kx)}, the DAC values of arithmetic table k; lossless,
    (predictor, point transform) for jpeg_enable_lossless; adobe, to write
    or drop the Adobe APP14 marker; tables, (DC, AC) table of each
    component. ValueError with libjpeg's message for settings it
    refuses."""
    global _WORKER
    px = np.ascontiguousarray(px, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    if _WORKER is None or _WORKER.poll() is not None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        _WORKER = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=repo)
    request = pickle.dumps((px, settings))
    try:
        _WORKER.stdin.write(struct.pack("<Q", len(request)) + request)
        _WORKER.stdin.flush()
        kind = _read(_WORKER.stdout, 1)
        payload = _read(_WORKER.stdout,
                        struct.unpack("<Q", _read(_WORKER.stdout, 8))[0])
    except (BrokenPipeError, EOFError):
        _WORKER.wait()
        raise ValueError("libjpeg's compressor ended without an answer") \
            from None
    if kind == b"E":                   # the worker ends after libjpeg's error
        _WORKER.wait()
    if kind != b"K":
        raise ValueError(f"libjpeg refused the settings: "
                         f"{payload.decode(errors='replace')}")
    return payload


if __name__ == "__main__":
    serve()
