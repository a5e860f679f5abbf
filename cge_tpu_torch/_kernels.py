"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled at first use by `nvcc`, one process
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/cge_tpu_torch/` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once. Nothing here runs at import time: a machine without `nvcc` (the
CPU test machine) imports the package and never calls `library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_PKG, "csrc", name)
                for name in ("cluster_sweep.cu", "sweep.cu",
                             "stream_probe.cu"))
# included by the sources: part of the build's hash
HEADERS = (os.path.join(_PKG, "csrc", "async_copy.cuh"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cge_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # rays, boxes, keys, NB, S, BR, stream
    "cge_block_entry_keys": (_P, _P, _P, _I, _I, _I, _P),
    # order, skeys, rays, tiles, best_t, best_i, visits, dense, NB, n_sc,
    # BR, sc_n, C, any_hit, cs, wpm, stream
    "cge_cluster_walk_mxu": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P),
    # order, skeys, rays, tiles, aabbs, best_t, best_i, visits, dense, NB,
    # n_sc, BR, sc_n, C, field_major, any_hit, shared_origin, refine, cs,
    # lanes, stream
    "cge_cluster_walk_split": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # o, d, tmax, table, best_t, best_i, part_t, part_i, R, T, n_split,
    # stream
    "cge_closest_tris_sweep": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P),
    # stack, partial, out, step_floats, n_steps, steps_per_block, n_blocks,
    # w, stream
    "cge_stream_sum": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        self._lib.cge_error_string.argtypes = [ctypes.c_int]
        self._lib.cge_error_string.restype = ctypes.c_char_p

    def check(self, err: int, name: str) -> None:
        """Raise on a nonzero cudaError_t returned by a launch."""
        if err != 0:
            msg = self._lib.cge_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"cge_kernels_{h.hexdigest()[:16]}.so")
    log_path = path + ".log"
    t0 = time.perf_counter()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode]
        if not failed:
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode:
                failed = ["link"]
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, path)    # atomic: concurrent builds agree
    seconds = time.perf_counter() - t0
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY

