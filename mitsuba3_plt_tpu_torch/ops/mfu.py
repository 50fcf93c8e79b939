"""The FP32 FMA roof probe (`csrc/fma_roof.cu`), its plain PyTorch
version, and the count of the instructions it issues, read from its SASS;
and the instructions of the special functions of the lobe sum on their
fast paths, read from the SASS of one-function probes
(`csrc/grating.cu::fn_probe_kernel`).

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


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)(?:\.\S+)?\s*([^;]*);")
_HEX = re.compile(r"0x([0-9a-f]+)")


def _kernel_sass(sass: str, kernel: str) -> list:
    """[(address, opcode, operands, predicated)] of `kernel` in `cuobjdump
    -sass` text (predicated: under a predicate other than PT)."""
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _SASS_LINE.search(line) if inside else None
        if m:
            pred = (m.group(2) or "").strip()
            body.append((int(m.group(1), 16), m.group(3), m.group(4).strip(),
                         pred not in ("", "@PT")))
    if not body:
        raise RuntimeError(f"no SASS for {kernel}")
    return body


def _issued(addr, op, arg, _pred=False):
    """Whether a SASS row issues: NOPs and the BRA to itself after EXIT
    never do."""
    return not (op == "NOP" or (op == "BRA" and arg == hex(addr)))


def _loops(body):
    """[(head, backward branch)] addresses of every branch of `body` (rows
    of `_kernel_sass`) whose target lies before it, taken or predicated."""
    out = []
    for addr, op, arg, _ in body:
        hexes = _HEX.findall(arg) if op == "BRA" else []
        if hexes and int(hexes[-1], 16) < addr:
            out.append((int(hexes[-1], 16), addr))
    return out


def _loop_rows(body, loop):
    """The rows of `body` from the loop's head to its branch that issue."""
    return [r for r in body if loop[0] <= r[0] <= loop[1] and _issued(*r)]


# the q test's det epsilon, 1e-12 as float32, as cuobjdump prints it
_DET_EPS_SASS = re.compile(r"\b9\.99999996\d*e-13\b")
# the classes a q test's instructions are counted in
Q_CLASSES = ("ffma", "fmul", "fadd", "fsetp", "lop3", "lds", "other")


def count_sass(sass: str, kernel: str, per_test: bool = False) -> dict:
    """Instructions a thread of `kernel` issues, from `cuobjdump -sass`
    text: {"ffma", "fmnmx", "other", "slots"} per thread, with the step
    loop (the kernel's one backward branch) counted as many times as its
    FFMAs divide FMA_ITERS; "loop" and "outside" give the two parts and
    "per_step" the instructions of one step of the four chains. NOPs and
    the BRA to itself after EXIT, which never issue, are left out.

    per_test=True reads a q kernel (`csrc/intersect_q.cu`, the sweep's
    `csrc/intersect_sweep.cu`; their loops nest): its row loop is the
    innermost loop (a backward branch, taken or predicated, spanning no
    other) with the most FSETPs against the det epsilon 1e-12, and one
    trip of it runs as many (ray, row) tests as it holds such FSETPs (a
    kernel built without FMA contraction has no FFMA to tell its row loop
    by). Returns {"tests_per_trip", "loop": the trip's
    instructions by class (Q_CLASSES), "ops": by opcode, "per_test": each
    class and "slots" over the tests}."""
    body = _kernel_sass(sass, kernel)
    if per_test:
        return _count_per_test(body, kernel)
    loops = []
    for addr, op, arg, _ in body:
        t = re.fullmatch(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            loops.append((int(t.group(1), 16), addr))
    if len(loops) > 1:
        raise RuntimeError(f"count_sass: {len(loops)} loops in {kernel}")

    def tally(rows):
        out = {"ffma": 0, "fmnmx": 0, "other": 0}
        for addr, op, arg, _ in rows:
            if _issued(addr, op, arg):
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


def _count_per_test(body, kernel):
    loops = _loops(body)
    inner = [a for a in loops
             if not any(b != a and a[0] <= b[0] and b[1] <= a[1]
                        for b in loops)]
    if not inner:
        raise RuntimeError(f"count_sass: no loop in {kernel}")

    def det_tests(rows):
        return sum(op == "FSETP" and bool(_DET_EPS_SASS.search(arg))
                   for _, op, arg, _ in rows)

    rows = max((_loop_rows(body, a) for a in inner), key=det_tests)
    tests = det_tests(rows)
    if not tests:
        raise RuntimeError(f"count_sass: no det epsilon in {kernel}'s loop")
    ops, loop = {}, dict.fromkeys(Q_CLASSES, 0)
    for _, op, _, _ in rows:
        ops[op] = ops.get(op, 0) + 1
        loop[op.lower() if op.lower() in Q_CLASSES else "other"] += 1
    per = {k: v / tests for k, v in loop.items()}
    per["slots"] = len(rows) / tests
    return {"tests_per_trip": tests, "loop": loop, "ops": ops,
            "per_test": per}


# the tensor cores' matrix instruction, by which `loop_trip` finds a loop
TC_OP = "HMMA"


def loop_trip(sass: str, kernel: str, per_test: bool = False,
              tests: int | None = None) -> dict:
    """The loop of `kernel` (a backward branch and its target) with the most
    TC_OP instructions, the smallest such, from `cuobjdump -sass` text:
    {"trip": the instructions by opcode on the fewest-instruction way from
    the loop's head to its backward branch (a predicated forward branch may
    go either way, an unconditional one must be taken, one that leaves the
    loop and the backward branches of loops inside it never are: a trip
    that takes no rare branch), "slots": their sum, "span": every
    instruction of the loop's addresses by opcode}. NOPs and the BRA to
    itself after EXIT are not counted.

    per_test=True reads a row loop whose rare branch holds a candidate's
    test (B8a's `classic_kernel`): the loop with the most FSETPs against
    the det epsilon 1e-12, the smallest such, whose trip runs `tests`
    (ray, row) tests (the source's rows a trip: required, since nvcc may
    compare one det twice); adds "tests_per_trip" and "per_test": the
    trip's opcodes and "slots" over its tests."""
    if per_test and not tests:
        raise ValueError("loop_trip: per_test needs the tests a trip runs")
    rows = _kernel_sass(sass, kernel)
    loops = _loops(rows)
    if not loops:
        raise RuntimeError(f"loop_trip: no loop in {kernel}")
    if per_test:
        what = "det epsilon"

        def mark(r):
            return r[1] == "FSETP" and bool(_DET_EPS_SASS.search(r[2]))
    else:
        what = TC_OP

        def mark(r):
            return r[1] == TC_OP
    lo, hi = max(loops, key=lambda a: (
        sum(map(mark, _loop_rows(rows, a))), a[0] - a[1]))
    body = _loop_rows(rows, (lo, hi))
    if not any(map(mark, body)):
        raise RuntimeError(f"loop_trip: no {what} in {kernel}'s loops")
    at = {r[0]: k for k, r in enumerate(body)}
    inf = float("inf")
    # the fewest instructions from row k to the backward branch, and the
    # row each takes next (None: the end)
    cost, step = [inf] * (len(body) + 1), [None] * len(body)
    for k in range(len(body) - 1, -1, -1):
        addr, op, args, cond = body[k]
        if addr == hi:
            cost[k] = 1
            continue
        nxt = [(cost[k + 1], k + 1)]
        if op == "BRA":
            hexes = _HEX.findall(args)
            target = at.get(int(hexes[-1], 16)) if hexes else None
            taken = (cost[target], target) if target is not None \
                and body[target][0] > addr else (inf, None)
            branchy = cond or args != (hexes and "0x" + hexes[-1])
            nxt = [taken] + (nxt if branchy else [])
        elif op in ("EXIT", "RET"):
            nxt = nxt if cond else [(inf, None)]
        best = min(nxt, key=lambda c: c[0])
        cost[k], step[k] = 1 + best[0], best[1]
    if cost[0] == inf:
        raise RuntimeError(f"loop_trip: no way round {kernel}'s loop")
    path, k = [], 0
    while k is not None and k < len(body):
        path.append(body[k])
        k = None if body[k][0] == hi else step[k]
    trip, every = {}, {}
    for r in path:
        trip[r[1]] = trip.get(r[1], 0) + 1
    for r in body:
        every[r[1]] = every.get(r[1], 0) + 1
    out = {"trip": trip, "slots": len(path), "span": every}
    if per_test:
        out["tests_per_trip"] = tests
        out["per_test"] = {**{op: v / tests for op, v in trip.items()},
                           "slots": len(path) / tests}
    return out


def fast_path(sass: str, kernel: str) -> dict:
    """The fewest instructions a thread of `kernel` can issue from its entry
    to an unpredicated EXIT, in `cuobjdump -sass` text: {"ffma", "other",
    "slots"}. A predicated branch may go either way, a backward branch is
    never taken (no loop trip), an unpredicated branch must be, a CALL
    costs its callee's fewest instructions to RET, a predicated EXIT falls
    through (the thread goes on). NOPs and the BRA to itself after EXIT
    are not counted. For a kernel whose only branches are a library
    function's tests for its slow path, that is its fast path."""
    rows = _kernel_sass(sass, kernel)
    at = {r[0]: k for k, r in enumerate(rows)}
    inf = (float("inf"), 0)
    # the fewest (slots, ffma) from row k to EXIT and to RET
    to_exit, to_ret = [inf] * (len(rows) + 1), [inf] * (len(rows) + 1)

    def plus(w, c):
        return (w[0] + c[0], w[1] + c[1])

    for k in range(len(rows) - 1, -1, -1):
        addr, op, args, cond = rows[k]
        hexes = _HEX.findall(args)
        target = at.get(int(hexes[-1], 16)) if hexes else None
        w = (0, 0) if op == "NOP" or (op == "BRA" and args == hex(addr)) \
            else (1, int(op == "FFMA"))
        for table in (to_exit, to_ret):
            if op in ("EXIT", "RET"):
                done = (op == "EXIT") == (table is to_exit)
                cost = table[k + 1] if cond else (w if done else inf)
                cost = plus(w, cost) if cond else cost
            elif op == "BRA":
                # a BRA whose operands hold more than its target (BRA.DIV,
                # a uniform predicate) is conditional too
                branchy = cond or args != (hexes and "0x" + hexes[-1])
                taken = (table[target] if target is not None
                         and rows[target][0] > addr else inf)
                cost = plus(w, min(taken, table[k + 1] if branchy else inf))
            elif op == "CALL":
                callee = (to_ret[target] if target is not None
                          and rows[target][0] > addr else inf)
                cost = plus(plus(w, callee), table[k + 1])
            else:
                cost = plus(w, table[k + 1])
            table[k] = cost
    slots, ffma = to_exit[0]
    if slots == float("inf"):
        raise RuntimeError(f"fast_path: no way to EXIT in {kernel}")
    return {"ffma": ffma, "other": slots - ffma, "slots": slots}


# the special functions of the lobe sum, by fn_probe_kernel<F>'s F
SPECIAL_FNS = {"sqrt": 1, "div": 2, "asin": 3, "exp": 4, "sincos": 5,
               "sin": 6}


def special_fn_counts(sass: str) -> dict:
    """{function: {"ffma", "other", "slots"}}: the fast path of each
    special function (`fast_path` of its probe less that of the identity
    probe, F = 0)."""
    def probe(f):
        return fast_path(sass, f"fn_probe_kernelILi{f}E")

    own = probe(0)
    out = {}
    for name, f in SPECIAL_FNS.items():
        c = probe(f)
        out[name] = {k: c[k] - own[k] for k in ("ffma", "other", "slots")}
    return out


def library_sass() -> str:
    """`cuobjdump -sass` of the built kernel library: needs the library,
    so a card's machine."""
    from .build import find_nvcc, load_library, library_file

    load_library()
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", library_file()], check=True,
                          stdout=subprocess.PIPE, text=True).stdout


def fma_roof_sass() -> dict:
    """`count_sass` of the built probe."""
    return count_sass(library_sass(), "fma_roof_kernel")
