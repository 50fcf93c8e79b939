"""The FP32 FMA roof probe (`csrc/fma_roof.cu`), its plain PyTorch
version, and the count of the instructions it issues, read from its SASS.

The probe is the JAX tool's `tools/experiments/kernel_mfu.py::_fma_kernel`:
per element of x [rows, 128] four chains of FMA_STEPS steps
x = min(x a + c, 3e38) with a = a[row % 8] from a [8, 128], so
FMA_ITERS = 4 FMA_STEPS fused multiply-adds an element.
"""
from __future__ import annotations

import os
import re
import subprocess

import torch

from ._check import check_tensors

FMA_ROOF_LAUNCHES = 0

SUB, LANES = 8, 128  # the rows and lanes of a, the tile of x
FMA_ITERS = 2048     # fused multiply-adds an element (four chains)
FMA_STEPS = FMA_ITERS // 4
_CLAMP = 3e38
# the derived chains x0 k + c and each chain's step constant, as float32
_DERIVED = ((1.0000001, 0.25), (0.9999999, 0.5), (1.0000002, 0.75))
_STEP_C = (1e-9, 2e-9, 3e-9, 4e-9)


def _f32(v):
    return float(torch.tensor(v, dtype=torch.float32))


def _check(name, x, a):
    dev, _ = check_tensors(name, {"x": (x, torch.float32, (LANES,)),
                                  "a": (a, torch.float32, None)})
    if x.shape[0] % SUB or tuple(a.shape) != (SUB, LANES):
        raise ValueError(f"{name}: x must be [8 k, 128] and a [8, 128], got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    return dev


def fma_roof_plain(x, a):
    """Plain version of `fma_roof`: each x a + c formed in float64 (the
    product of two float32 values is exact there) and rounded to float32
    once, as one fmaf rounds it (double rounding can move an element by an
    ulp), then the clamp; the output (x0 + x1) + (x2 + x3) in float32."""
    av = a.double().repeat(x.shape[0] // SUB, 1)

    def fma(v, k, c):
        return (v.double() * k + _f32(c)).float()

    x0 = x
    xs = [x0] + [fma(x0, _f32(k), c) for k, c in _DERIVED]
    for _ in range(FMA_STEPS):
        xs = [torch.clamp_max(fma(v, av, c), _CLAMP)
              for v, c in zip(xs, _STEP_C)]
    return (xs[0] + xs[1]) + (xs[2] + xs[3])


def fma_roof(x, a):
    """The FMA roof probe over x [rows, 128] (rows a multiple of 8) and
    a [8, 128] float32: [rows, 128] float32. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    global FMA_ROOF_LAUNCHES
    dev = _check("fma_roof", x, a)
    if dev.type == "cpu":
        return fma_roof_plain(x, a)
    from .build import check, load_library

    lib = load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_fma_roof(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                           x.shape[0], stream), "fma_roof")
    FMA_ROOF_LAUNCHES += 1
    return out


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)(?:\.\S+)?\s*([^;]*);")


def count_sass(sass: str, kernel: str) -> dict:
    """Instructions a thread of `kernel` issues, from `cuobjdump -sass`
    text: {"ffma", "fmnmx", "other", "slots"} per thread, with the step
    loop (the kernel's one backward branch) counted as many times as its
    FFMAs divide FMA_ITERS; "loop" and "outside" give the two parts and
    "per_step" the instructions of one step of the four chains. NOPs and
    the BRA to itself after EXIT, which never issue, are left out."""
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _SASS_LINE.search(line) if inside else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    if not body:
        raise RuntimeError(f"count_sass: no SASS for {kernel}")
    loops = []
    for addr, op, arg in body:
        t = re.fullmatch(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            loops.append((int(t.group(1), 16), addr))
    if len(loops) > 1:
        raise RuntimeError(f"count_sass: {len(loops)} loops in {kernel}")

    def tally(rows):
        out = {"ffma": 0, "fmnmx": 0, "other": 0}
        for addr, op, arg in rows:
            if op == "NOP" or (op == "BRA" and arg == hex(addr)):
                continue
            out["ffma" if op == "FFMA" else "fmnmx" if op == "FMNMX"
                else "other"] += 1
        return out

    lo, hi = loops[0] if loops else (0, -1)
    inner = tally([r for r in body if lo <= r[0] <= hi])
    outer = tally([r for r in body if not lo <= r[0] <= hi])
    trips = FMA_ITERS // inner["ffma"] if inner["ffma"] else 0
    issued = {k: outer[k] + trips * inner[k] for k in outer}
    return {**issued, "slots": sum(issued.values()), "loop_trips": trips,
            "loop": inner, "outside": outer,
            "per_step": {k: v / FMA_STEPS for k, v in issued.items()}}


def fma_roof_sass() -> dict:
    """`count_sass` of the built probe (`cuobjdump -sass` of the kernel
    library): needs the library, so a card's machine."""
    from .build import find_nvcc, load_library, library_file

    load_library()
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library_file()], check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    return count_sass(out, "fma_roof_kernel")
