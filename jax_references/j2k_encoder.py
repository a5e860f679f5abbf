"""JPEG 2000 codestreams that Pillow's save does not write, through Pillow's
own OpenJPEG (pillow.libs/libopenjp2-*.so) driven with ctypes: any
code-block style (bypass, reset, termall, vertically causal, predictable
termination, segmentation symbols), ROI max-shift, POC, subsampled
components, precisions 1 to 16 (signed or not), image and tile offsets,
tile-parts, SOP / EPH, PLT and TLM. The JAX side of the port's texture
tests uses it to write JPEG 2000 fixtures (make_textures.py) and
test-time files.

OpenJPEG's encoder asserts (aborts the process) on some settings, so it
runs in a worker process of its own (`python3 jax_references/
j2k_encoder.py`, started at the first call and kept); `j2k_encode` raises
ValueError where the worker ends without an answer, and the next call
starts a new one. Requests and answers are pickles between this module
and its worker.
"""

from __future__ import annotations

import ctypes
import glob
import os
import pickle
import struct
import subprocess
import sys
import tempfile

import numpy as np

I, U, P, F = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_float
PATH_LEN, MAXRLVLS, JPWL = 4096, 33, 16
PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block style bits (COD's SPcod)
STYLE = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16,
         "segsym": 32}


class Poc(ctypes.Structure):
    """opj_poc_t (148 bytes)."""
    _fields_ = [("resno0", U), ("compno0", U), ("layno1", U), ("resno1", U),
                ("compno1", U), ("layno0", U), ("precno0", U),
                ("precno1", U), ("prg1", I), ("prg", I),
                ("progorder", ctypes.c_char * 5), ("tile", U),
                ("rest", U * 24)]


class Params(ctypes.Structure):
    """opj_cparameters_t of OpenJPEG 2.5 (checked against the defaults
    opj_set_default_encoder_parameters writes)."""
    _fields_ = [
        ("tile_size_on", I), ("cp_tx0", I), ("cp_ty0", I), ("cp_tdx", I),
        ("cp_tdy", I), ("cp_disto_alloc", I), ("cp_fixed_alloc", I),
        ("cp_fixed_quality", I), ("cp_matrice", P), ("cp_comment", P),
        ("csty", I), ("prog_order", I), ("POC", Poc * 32), ("numpocs", U),
        ("tcp_numlayers", I), ("tcp_rates", F * 100),
        ("tcp_distoratio", F * 100), ("numresolution", I),
        ("cblockw_init", I), ("cblockh_init", I), ("mode", I),
        ("irreversible", I), ("roi_compno", I), ("roi_shift", I),
        ("res_spec", I), ("prcw_init", I * MAXRLVLS),
        ("prch_init", I * MAXRLVLS), ("infile", ctypes.c_char * PATH_LEN),
        ("outfile", ctypes.c_char * PATH_LEN), ("index_on", I),
        ("index", ctypes.c_char * PATH_LEN), ("image_offset_x0", I),
        ("image_offset_y0", I), ("subsampling_dx", I),
        ("subsampling_dy", I), ("decod_format", I), ("cod_format", I),
        ("jpwl", I * (2 + 5 * JPWL + 4 + 2 * JPWL)), ("cp_cinema", I),
        ("max_comp_size", I), ("cp_rsiz", I), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
        ("jpip_on", I), ("mct_data", P), ("max_cs_size", I),
        ("rsiz", ctypes.c_uint16), ("spare", ctypes.c_char * 4096)]


class CompParam(ctypes.Structure):
    """opj_image_cmptparm_t."""
    _fields_ = [("dx", U), ("dy", U), ("w", U), ("h", U), ("x0", U),
                ("y0", U), ("prec", U), ("bpp", U), ("sgnd", U)]


class Comp(ctypes.Structure):
    """opj_image_comp_t."""
    _fields_ = [("dx", U), ("dy", U), ("w", U), ("h", U), ("x0", U),
                ("y0", U), ("prec", U), ("bpp", U), ("sgnd", U),
                ("resno_decoded", U), ("factor", U),
                ("data", ctypes.POINTER(ctypes.c_int32)),
                ("alpha", ctypes.c_uint16)]


class Image(ctypes.Structure):
    """opj_image_t."""
    _fields_ = [("x0", U), ("y0", U), ("x1", U), ("y1", U),
                ("numcomps", U), ("color_space", I),
                ("comps", ctypes.POINTER(Comp)), ("icc", P), ("icc_len", U)]


def _lib():
    here = os.path.dirname(__import__("PIL").__file__)
    (path,) = glob.glob(os.path.join(here, "..", "pillow.libs",
                                      "libopenjp2-*.so*"))
    lib = ctypes.CDLL(path)
    lib.opj_image_create.restype = ctypes.POINTER(Image)
    lib.opj_image_create.argtypes = [U, ctypes.POINTER(CompParam), I]
    lib.opj_create_compress.restype = P
    lib.opj_create_compress.argtypes = [I]
    lib.opj_setup_encoder.argtypes = [P, ctypes.POINTER(Params),
                                      ctypes.POINTER(Image)]
    lib.opj_encoder_set_extra_options.argtypes = [P, ctypes.POINTER(
        ctypes.c_char_p)]
    lib.opj_stream_create_default_file_stream.restype = P
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          I]
    lib.opj_start_compress.argtypes = [P, ctypes.POINTER(Image), P]
    lib.opj_encode.argtypes = [P, P]
    lib.opj_end_compress.argtypes = [P, P]
    lib.opj_stream_destroy.argtypes = [P]
    lib.opj_destroy_codec.argtypes = [P]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(Image)]
    lib.opj_set_MCT.argtypes = [ctypes.POINTER(Params), P, P, U]
    return lib


def _check_layout(lib) -> None:
    p = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno,
           p.subsampling_dx, p.subsampling_dy, p.decod_format, p.cod_format)
    if got != (6, 64, 64, -1, 1, 1, -1, -1):
        raise RuntimeError(f"opj_cparameters_t's layout is not this "
                           f"module's: {got}")


def _compress(lib, planes: list, *, image_offset=(0, 0), sampling=None,
              precision=8, signed=False, tiles=None, tile_offset=(0, 0),
              resolutions=None, codeblock=(64, 64), precincts=None,
              progression="LRCP", pocs=(), layers=None, irreversible=False,
              mct=None, styles=(), roi=None, sop=False, eph=False,
              tile_parts=None, plt=False, tlm=False, jp2=False,
              colour=1, mct_matrix=None, mct_shift=None) -> bytes:
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    prec = precision if isinstance(precision, (list, tuple)) else [
        precision] * n
    sgnd = signed if isinstance(signed, (list, tuple)) else [signed] * n
    ox, oy = image_offset
    # the reference grid: the first component's samples at its sampling
    dx0, dy0 = sampling[0]
    h0, w0 = planes[0].shape
    x1, y1 = ox + w0 * dx0, oy + h0 * dy0
    cp = (CompParam * n)()
    for i, (plane, (dx, dy)) in enumerate(zip(planes, sampling)):
        cx0, cy0 = -(-ox // dx), -(-oy // dy)
        w, h = -(-x1 // dx) - cx0, -(-y1 // dy) - cy0
        if plane.shape != (h, w):
            raise ValueError(f"component {i} must be {h}x{w} samples")
        cp[i] = CompParam(dx, dy, w, h, cx0, cy0, prec[i], prec[i],
                          int(sgnd[i]))
    image = lib.opj_image_create(n, cp, colour)
    im = image.contents
    im.x0, im.y0, im.x1, im.y1 = ox, oy, x1, y1
    for i, plane in enumerate(planes):
        flat = np.ascontiguousarray(plane, np.int32).ravel()
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    if tiles:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tiles
        p.cp_tx0, p.cp_ty0 = tile_offset
    if resolutions is None:
        # OpenJPEG's default of 6, fewer where a tile's component is smaller
        # than 2^(resolutions - 1) samples
        side = min(min(c.w, c.h) for c in cp)
        if tiles:
            side = min(side, *(-(-t // max(d for s in sampling for d in s))
                               for t in tiles))
        resolutions = 1
        while resolutions < 6 and side >> resolutions:
            resolutions += 1
    p.numresolution = resolutions
    p.cblockw_init, p.cblockh_init = codeblock
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = pw, ph
    p.csty |= (2 if sop else 0) | (4 if eph else 0)
    p.prog_order = PROG[progression]
    for i, (resno0, compno0, layno1, resno1, compno1, prg, tile) in \
            enumerate(pocs):
        q = p.POC[i]
        q.resno0, q.compno0, q.layno1 = resno0, compno0, layno1
        q.resno1, q.compno1, q.tile = resno1, compno1, tile
        q.prg1 = PROG[prg]
    p.numpocs = len(pocs)
    if layers:
        p.tcp_numlayers = len(layers)
        p.cp_disto_alloc = 1
        for i, r in enumerate(layers):
            p.tcp_rates[i] = r
    else:
        p.tcp_numlayers = 1
        p.tcp_rates[0] = 0
        p.cp_disto_alloc = 1
    p.irreversible = int(irreversible)
    p.tcp_mct = bytes([(1 if n >= 3 else 0) if mct is None else int(mct)])
    if mct_matrix is not None:
        matrix = np.asarray(mct_matrix, np.float32).ravel()
        shift = np.asarray(mct_shift if mct_shift is not None else [0] * n,
                           np.int32)
        if not lib.opj_set_MCT(ctypes.byref(p), matrix.ctypes.data,
                               shift.ctypes.data, n):
            raise ValueError("opj_set_MCT failed")
    p.mode = sum(STYLE[s] for s in styles)
    if roi:
        p.roi_compno, p.roi_shift = roi
    if tile_parts:
        p.tp_on = b"\x01"
        p.tp_flag = tile_parts.encode()
    codec = lib.opj_create_compress(2 if jp2 else 0)
    try:
        if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
            raise ValueError("opj_setup_encoder refused the settings")
        extra = [o.encode() for o, on in (("PLT=YES", plt), ("TLM=YES", tlm))
                 if on]
        if extra:
            opts = (ctypes.c_char_p * (len(extra) + 1))(*extra, None)
            if not lib.opj_encoder_set_extra_options(codec, opts):
                raise ValueError("OpenJPEG refused the extra options")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.j2k")
            stream = lib.opj_stream_create_default_file_stream(
                path.encode(), 0)
            ok = (lib.opj_start_compress(codec, image, stream)
                  and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
            if not ok:
                raise ValueError("OpenJPEG's encoder failed")
            with open(path, "rb") as f:
                return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


def _answer(stream, kind: bytes, payload: bytes) -> None:
    stream.write(kind + struct.pack("<Q", len(payload)) + payload)
    stream.flush()


def _read(stream, n: int) -> bytes:
    data = stream.read(n)
    if len(data) != n:
        raise EOFError
    return data


def serve() -> None:
    """The worker: (planes, settings) pickles in, out b"K" and the
    codestream, or b"P" and an error's message, until its input ends."""
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    lib = _lib()
    _check_layout(lib)
    while True:
        try:
            n = struct.unpack("<Q", _read(inp, 8))[0]
        except EOFError:
            return
        planes, settings = pickle.loads(_read(inp, n))
        try:
            data = _compress(lib, planes, **settings)
        except (TypeError, KeyError, ValueError) as e:
            _answer(out, b"P", repr(e).encode())
        else:
            _answer(out, b"K", data)


_WORKER: subprocess.Popen | None = None


def j2k_encode(planes, **settings) -> bytes:
    """Components (a list of int [h, w] planes, each at its own sampling)
    through OpenJPEG's encoder: the codestream's bytes (a JP2 file with
    jp2=True).

    settings: image_offset (x0, y0) on the reference grid; sampling, (dx,
    dy) of each component; precision and signed, one for all or one a
    component; tiles (width, height) and tile_offset; codeblock (width,
    height); precincts [(log2 width, log2 height)] from the highest
    resolution down; progression; pocs [(resno0, compno0, layno1, resno1,
    compno1, progression, tile from 1)]; layers, the rates of the quality
    layers; resolutions, by default 6 or as many as the smallest tile's
    component holds; irreversible; mct; styles, names of STYLE; roi
    (component, shift); sop, eph; tile_parts "R", "L" or "C"; plt, tlm; jp2,
    colour (OpenJPEG's colour space). ValueError where OpenJPEG refuses the
    settings or its worker ends."""
    global _WORKER
    planes = [np.ascontiguousarray(p, np.int32) for p in planes]
    if _WORKER is None or _WORKER.poll() is not None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        _WORKER = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, cwd=repo)
    request = pickle.dumps((planes, settings))
    try:
        _WORKER.stdin.write(struct.pack("<Q", len(request)) + request)
        _WORKER.stdin.flush()
        kind = _read(_WORKER.stdout, 1)
        payload = _read(_WORKER.stdout,
                        struct.unpack("<Q", _read(_WORKER.stdout, 8))[0])
    except (BrokenPipeError, EOFError):
        _WORKER.wait()
        raise ValueError("OpenJPEG's encoder ended without an answer") \
            from None
    if kind != b"K":
        raise ValueError(f"OpenJPEG refused the settings: "
                         f"{payload.decode(errors='replace')}")
    return payload


if __name__ == "__main__":
    serve()
