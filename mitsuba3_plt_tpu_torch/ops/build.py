"""Build and bind the CUDA kernels of `ops/csrc/`.

At first use the sources are compiled by `nvcc` for sm_90a (one process per
source, all started together), linked into one shared library with a plain C
interface, and loaded with ctypes. The library lands in `_build/` of this
package, named by a hash of the sources and flags, so an edited source
rebuilds. A missing `nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("intersect_q.cu", "intersect_clu2.cu", "intersect_bvh.cu",
           "intersect_classic.cu", "intersect_mxu.cu", "intersect_clu.cu",
           "intersect_sweep.cu", "grating.cu", "fma_roof.cu")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as void*, counts as int
SIGNATURES = {
    "plt_intersect_q": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "plt_occluded_q": [_P, _I, _P, _P, _P, _P, _I, _P, _P],
    "plt_intersect_clu2": [_P, _P, _I] + [_P] * 7 + [_I] + [_P] * 5,
    "plt_occluded_clu2": [_P, _P, _I] + [_P] * 7 + [_I, _P, _P],
    "plt_intersect_bvh": [_P] * 5 + [_I, _I] + [_P] * 5,
    "plt_occluded_bvh": [_P] * 5 + [_I, _I, _P, _P],
    "plt_intersect_classic": [_P, _I] + [_P] * 3 + [_I] + [_P] * 5,
    "plt_intersect_classic_audit": [_P, _I] + [_P] * 3 + [_I] + [_P] * 6,
    "plt_occluded_classic": [_P, _I] + [_P] * 3 + [_I, _P, _P],
    "plt_intersect_mxu": [_P, _I, _I] + [_P] * 3 + [_I] + [_P] * 5,
    "plt_intersect_mxu_unfiltered": [_P, _I, _I] + [_P] * 3 + [_I] + [_P] * 6,
    "plt_intersect_clu": [_P, _I] + [_P] * 5 + [_I] + [_P] * 5,
    "plt_occluded_clu": [_P, _I] + [_P] * 5 + [_I, _P, _P],
    "plt_intersect_q_variant": [_P, _I] + [_P] * 4 + [_I, _P, _P, _I, _I,
                                                      _P],
    "plt_occluded_q_variant": [_P, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "plt_intersect_q_macc": [_P, _I] + [_P] * 4 + [_I] + [_P] * 4 + [_I,
                                                                      _P],
    "plt_grating_lobe_sum": [_P] * 12 + [_I, _I, _I, _I, _P, _P, _P],
    "plt_grating_lobe_sum_bwd": [_P] * 13 + [_I, _I, _I, _I] + [_P] * 9,
    "plt_grating_sample": [_P] * 11 + [_I, _I, _I] + [_P] * 7 + [_P],
    "plt_fma_roof": [_P, _P, _P, _I, _P],
}

_lib = None
build_log = ""


def find_nvcc() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: str) -> None:
    global build_log
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src),
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            objs.append(obj)
        so_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", so_tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        build_log = "\n".join(logs)
        with open(target + ".log", "w") as f:
            f.write(build_log)
        os.replace(so_tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_file() -> str:
    """The path of the kernel library for the sources as they stand."""
    return os.path.join(BUILD_DIR, f"libplt_kernels_{_digest()}.so")


def load_library():
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    target = library_file()
    if not os.path.exists(target):
        _build(target)
    lib = ctypes.CDLL(target)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
