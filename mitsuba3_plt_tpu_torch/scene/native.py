"""ctypes binding of the repository's native SAH BVH builder
(`native/bvh_builder.cpp`).

At first use the source is compiled by g++ into this package's `_build/`,
named by a hash of the source and flags (the tracked library in `native/`
is neither used nor rebuilt). A missing compiler or a failed build raises:
there is no fallback builder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                      "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LEAF_SIZE = 4

_lib = None


def _build(target: str) -> None:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native BVH builder cannot be "
                           "built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stdout}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library():
    """The bound builder, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    target = os.path.join(BUILD_DIR,
                          f"libbvh_builder_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        _build(target)
    lib = ctypes.CDLL(target)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    lib.build_bvh.restype = i32
    lib.build_bvh.argtypes = [fp, fp, fp, i32, fp, fp, ip, ip, ip, i32, ip,
                              i32, ip]
    _lib = lib
    return lib


def build_bvh_native(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """SAH BVH of the triangles (p0, p1, p2) [F, 3]: (node_lo, node_hi,
    node_first, node_count, node_miss, prim_idx) in the skip-link layout
    documented in `scene/bvh.py`."""
    lib = load_library()
    nf = len(p0)
    cap = max(4 * (nf // LEAF_SIZE + 1) + 4, 16)
    prim_cap = cap * LEAF_SIZE
    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_miss = np.empty(cap, np.int32)
    prim_idx = np.empty(prim_cap, np.int32)
    prim_pad = ctypes.c_int32(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    nn = lib.build_bvh(
        p0.ctypes.data_as(fp), p1.ctypes.data_as(fp), p2.ctypes.data_as(fp),
        nf, node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
        node_first.ctypes.data_as(ip), node_count.ctypes.data_as(ip),
        node_miss.ctypes.data_as(ip), cap, prim_idx.ctypes.data_as(ip),
        prim_cap, ctypes.byref(prim_pad),
    )
    if nn < 0:
        raise RuntimeError(f"native BVH builder: capacity {cap} nodes too "
                           f"small for {nf} faces")
    pp = prim_pad.value
    return (node_lo[:nn].copy(), node_hi[:nn].copy(), node_first[:nn].copy(),
            node_count[:nn].copy(), node_miss[:nn].copy(),
            prim_idx[:pp].copy())
