#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, ~3 min with the build

Nine paths: the PLT flagship (grating_scene, B1-B4), the fixed-depth
path tracer on the 81,920-face mesh scene over the clu2 route (B5-B6), the
regenerative path tracer in Morton order on the same scene over the
packet-BVH route (B7a, B7b), the intersection bench tool
(`mitsuba3_plt_tpu_torch/tools/bench_isect.py`: B1, B2, B7a and the brute
forces B8a, B8b, B9 on the Cornell box's rays and on a 5,120-face
icosphere), the cluster-mask sort tool (`tools/isect_mask_sort.py`: the
flat cluster kernels B10a, B10b beside B1, B2) and the unroll sweep
(`tools/isect_unroll_sweep.py`: B11a, B11b beside B1, B2) and the
multi-accumulator q closest hit (`tools/isect_q_multiacc.py`: B11c beside
B1) on the same two scenes, the per-kernel MFU tool
(`tools/kernel_mfu.py`: the FMA roof probe B11d, an HBM probe, B1, B2, B5
and B4 against the card's measured and published roofs), and the path
tracer on the Cornell box (B1, B2, area light).
Phases, each printing one JSON line with its seconds:
  card            name and power limit (nvidia-smi) and torch's device name;
  build           the CUDA kernels from ops/csrc (one nvcc per source, all
                  started together), with nvcc's register and spill report;
  cbox-scene      cornell_box(512, 512): 36 faces, the brute route, the
                  area light's tables;
  kernels         each kernel against its plain PyTorch version on the
                  card, at the main paths' lane counts, with the tolerance
                  stated, timed with CUDA events (10 back-to-back calls,
                  median of 7; the clu2 and BVH plain walks once per ray
                  set). B7 runs on the five mesh82k ray sets of B5/B6 at
                  1,048,576 lanes, unsorted and sorted by the route's
                  coherence sort, whose own time is printed, and on the
                  131,072-lane wavefront the regenerative path gives it.
                  B8a, B8b and B9 run on the tool's coherent and incoherent
                  sets of the Cornell box and of the 5,120-face icosphere at
                  1,048,576 lanes, held to their plain versions on all the
                  box's lanes and on the icosphere's first 131,072 (B8 to
                  the bit, B9 within its tolerance). B10a (incoherent,
                  depth0) and B10b (shadow0) on the mask-sort tool's
                  icosphere sets, B11a at every unroll with one and two
                  accumulators and B11b at every unroll on the sweep's
                  rays of both scenes, all at 1,048,576 lanes, each equal
                  to its plain version to the bit on 131,072 lanes (all of
                  the Cornell box's for B11); B11c at nacc 2, 4 and 8 on
                  the multi-accumulator tool's 2,097,152 rays of both
                  scenes, equal to its plain version to the bit (t, prim,
                  u, v) on 131,072 lanes of the icosphere and all of the
                  Cornell box's; B11d at 8,192 x 128 on random inputs,
                  within 1 ulp of its plain version;
  isect-tool      bench_isect.run on both scenes: one row per route and ray
                  set (ms, M rays/s, agreement with brute-classic), and the
                  launches of one run on one set;
  mask-sort       isect_mask_sort.run on both scenes (1,048,576 rays a
                  set): the launches of one run on two sets, each sorted
                  and Morton pipeline equal to the unsorted kernel on every
                  lane, one row per route and set (ms, ms per M rays,
                  agreement with q);
  unroll-sweep    isect_unroll_sweep.run on both scenes (2^20 rays): the
                  launches of one run, one row per variant;
  q-multiacc      isect_q_multiacc.run on both scenes (2^21 rays): the
                  launches of one run, one row per nacc (prim agreement
                  with B1 >= 0.99);
  kernel-mfu      B11d's SASS (one FFMA and one FMNMX a chain a step), the
                  launches of one run of every probe, then the probes
                  timed: the FMA roof and HBM bandwidth chained, B1/B2 on
                  the q-multiacc rays of both scenes, B5 on the camera
                  rays of mesh_scene(1024, 1024, 6) with the host BVH walk,
                  B4 on the JAX tool's inputs, each against the measured
                  and the published roofs;
  golden          grating_scene(24, 24, coherence=1e3), PLT depth 3 / rr 9,
                  4 seeds x 12 spp, Sidak z-test against tests/golden/
                  grating_plt.npz;
  golden-mesh20k  mesh_scene(32, 32, subdiv=5), path depth 3 / rr 9, 4 seeds
                  x 8 spp, z-test against tests/golden/mesh20k_path.npz;
  golden-mesh20k-packet  the same on the packet route;
  golden-cbox     cornell_box(32, 32), path depth 4 / rr 9, 4 seeds x 16 spp,
                  z-test against tests/golden/cbox_path.npz;
  main            grating_scene(800, 600), PLT depth 7 / rr 50, 4 spp per
                  pass: one warm-up pass, three timed passes; the image must
                  be finite and non-zero, its four kernels launch 7 times per
                  pass (once per bounce) and the clu2 kernels never;
  split           device time of one such pass by kernel (torch.profiler),
                  written to chiprun_out/chip_smoke_profile.json;
  main-mesh82k    mesh_scene(512, 512, subdiv=6), path depth 4 / rr 3, 4 spp
                  per pass, as `main`: the clu2 kernels launch 4 times per
                  pass, the q and grating kernels never;
  split-mesh82k   as `split`, to chiprun_out/chip_smoke_profile_mesh82k.json;
  main-mesh82k-packet  the same scene on the packet route,
                  render(regen=True, pixel_order="morton"): 131,072 lanes,
                  B7a and B7b launch once per loop iteration, B1-B6 never;
                  the image equals the fixed-depth Morton render of the same
                  seed at rtol 2e-5 / atol 2e-6, and the scanline render to
                  noise;
  split-mesh82k-packet  to chiprun_out/chip_smoke_profile_mesh82k_packet.json;
  main-mesh82k-regen   the regenerative render on the clu2 route (B5 and B6
                  once per iteration), held to its fixed-depth render;
  main-cbox       cornell_box(512, 512), path depth 7 / rr 50, 8 spp per
                  pass (2,097,152 lanes), as `main`: B1 and B2 launch 7
                  times per pass, no other kernel;
  split-cbox      to chiprun_out/chip_smoke_profile_cbox.json.
Then the kernel list (each kernel's launches from its own path: B8a, B8b
and B9 from one tool run on one ray set, B10 and B11 from one run of
their tools; each bound against the published peaks and against the
roofs the kernel-mfu phase measured), the nvidia-smi line, and the final
status line. Every failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_W, MAIN_H, MAIN_SPP_PASS = 800, 600, 4
MAIN_DEPTH, MAIN_RR = 7, 50
MESH_W, MESH_H, MESH_SUBDIV, MESH_SPP_PASS = 512, 512, 6, 4
MESH_DEPTH, MESH_RR = 4, 3
CBOX_W, CBOX_H, CBOX_SPP_PASS = 512, 512, 8
CBOX_DEPTH, CBOX_RR = 7, 50
TOOL_LANES = 1 << 20       # rays per set of the intersection tool
MACC_LANES = 1 << 21       # rays of the multi-accumulator tool and the
                           # MFU tool's q probes
FMA_WIDE_ROWS = 1 << 16    # the FMA roof probe at 8x the JAX tool's rows
TOOL_SUBDIV = 4            # its icosphere: 5,120 faces
PLAIN_LANES = 131072       # lanes the icosphere's plain B8/B9 run on
TIMED_PASSES = 3

# kernel launches per pass of each main path; ITER stands for the
# iterations of the regenerative loop in that pass
ITER = "iteration"
NO_LAUNCHES = dict.fromkeys(
    ("intersect_q", "occluded_q", "grating_sample", "grating_lobe_sum",
     "intersect_clu2", "occluded_clu2", "intersect_bvh", "occluded_bvh",
     "intersect_classic", "occluded_classic", "intersect_mxu",
     "intersect_clu", "occluded_clu", "intersect_q_variant",
     "occluded_q_variant", "intersect_q_macc", "fma_roof"), 0)
GRATING_LAUNCHES = {**NO_LAUNCHES, "intersect_q": MAIN_DEPTH,
                    "occluded_q": MAIN_DEPTH, "grating_sample": MAIN_DEPTH,
                    "grating_lobe_sum": MAIN_DEPTH}
MESH_LAUNCHES = {**NO_LAUNCHES, "intersect_clu2": MESH_DEPTH,
                 "occluded_clu2": MESH_DEPTH}
PACKET_LAUNCHES = {**NO_LAUNCHES, "intersect_bvh": ITER, "occluded_bvh": ITER}
REGEN_CLU2_LAUNCHES = {**NO_LAUNCHES, "intersect_clu2": ITER,
                       "occluded_clu2": ITER}
CBOX_LAUNCHES = {**NO_LAUNCHES, "intersect_q": CBOX_DEPTH,
                 "occluded_q": CBOX_DEPTH}
REGEN = {"regen": True, "pixel_order": "morton"}
# kernels whose launches in the kernels line come from a tool's run
TOOL_KERNELS = ("intersect_classic", "occluded_classic", "intersect_mxu")
MASK_KERNELS = ("intersect_clu", "occluded_clu")
SWEEP_KERNELS = ("intersect_q_variant", "occluded_q_variant")
MACC_KERNELS = ("intersect_q_macc",)
MFU_KERNELS = ("fma_roof",)


def emit(obj):
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase; `emit` adds the seconds since it began."""

    def __init__(self, name):
        self.name, self.t0 = name, time.perf_counter()

    def emit(self, **fields):
        emit({"phase": self.name, **fields,
              "seconds": time.perf_counter() - self.t0})


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=7, calls=10, warmup=2):
    """Device time of one fn() call in ms: CUDA events around `calls`
    back-to-back calls (so the host's launch latency overlaps the device
    work), divided by `calls`; the median of `reps` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def time_once(fn):
    """(fn(), device time of that one call in ms by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def chained_ms(step, x, reps=7, calls=10):
    """Device time of one step(x) in ms with each call fed the last one's
    output (the JAX tool's chained timing): CUDA events around `calls`
    chained calls, the median of `reps` such runs."""
    import torch

    x = step(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            x = step(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes, n_ops, n_fma=0):
    """A kernel's least time against the published peaks: the larger of
    its bytes / 3.35 TB/s and its operations (an FMA two) / 67 TFLOP/s;
    with the bytes and the issue slots (the operations less one per FMA) that
    `measured_bound` sets against the card's measured roofs."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_slots": n_ops - n_fma}


def contracted_bound(n_bytes, n_ops):
    """`bound` of a kernel that nvcc builds with FMA contraction (grating.cu:
    B3, B4), whose operation count does not tell the FMAs apart: its issue
    slots are taken as n_ops / 2, the fewest it could issue (an FFMA, two
    operations, is the most one slot does), so its measured bound is a
    floor. Their SASS cannot give the count as B11d's does: it keeps loops
    and calls whose trips a static count cannot read."""
    return bound(n_bytes, n_ops, n_ops // 2)


def measured_bound(row, roofs):
    """The row's least time against the measured roofs (`kernel_mfu.roofs`):
    the larger of its bytes / the HBM probe's bytes/s and its issue slots /
    the FMA probe's instructions a second."""
    t_bytes = row["bound_bytes"] / roofs["bytes"] * 1e3
    t_slots = row["bound_slots"] / roofs["slots"] * 1e3
    return {"measured_bound_ms": max(t_bytes, t_slots),
            "measured_bound_by": "bytes" if t_bytes >= t_slots
            else "operations"}


def nbytes(*tensors):
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def frac_close(a, b, rtol, atol):
    """Fraction of rows of a, b (same shape) that agree elementwise."""
    import torch

    ok = torch.isclose(a, b, rtol=rtol, atol=atol)
    if ok.dim() > 1:
        ok = ok.all(dim=-1)
    # in float64: a float32 mean of a million ones can come out below 1
    return ok.double().mean().item() if ok.numel() else 1.0


def ptxas_report(log: str) -> tuple:
    """({kernel instance: registers per thread}, {kernel instance: spill
    bytes stored and loaded, where not 0}) from nvcc's -Xptxas -v report
    (entry names shortened to name<template args>)."""
    import re

    regs, spills, entry = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"(clu2_kernel|clu_kernel|bvh_kernel|sweep_q_kernel|"
                          r"sweep_a_kernel|q_kernel|lobe_sum_kernel|"
                          r"sample_kernel|classic_kernel)"
                          r"I((?:L[ib]\d+E)+)E", entry)
            if k:
                args = re.findall(r"L([ib])(\d+)E", k.group(2))
                entry = f"{k.group(1)}<{','.join(v for _, v in args)}>"
            elif "mxu_kernel" in entry:
                entry = "mxu_kernel"
            elif "fma_roof_kernel" in entry:
                entry = "fma_roof_kernel"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and int(m.group(1)) + int(m.group(2)):
            spills[entry] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs, spills


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# operation counts (each add, multiply, compare, select or special-function
# call counts as one), read off the kernels' algebra
# ---------------------------------------------------------------------------

Q_RAY_SETUP_OPS = 17      # anchor shift, o x d, maxt check, final divide
Q_TEST_OPS = 55           # det, u, v, t terms, sign fold, inside, best pair
Q_ANYHIT_TEST_OPS = 47    # the same without the best-pair update
CLU2_RAY_SETUP_OPS = 29   # the q setup plus the guarded inverse direction
SLAB_OPS = 29             # 6 sub, 6 mul, 10 min/max, gate compares and ands
BVH_RAY_SETUP_OPS = 22    # guarded inverse direction, maxt check, miss select
BVH_TEST_OPS = 64         # d x e2, det, guarded 1/det, u, tv x e1, v, t, hit, best
BVH_ANYHIT_TEST_OPS = 61  # the same without the best-hit update
CLASSIC_RAY_SETUP_OPS = 4  # maxt check, miss select
CLASSIC_TEST_OPS = BVH_TEST_OPS  # the same triangle test and best update
CLASSIC_ANYHIT_TEST_OPS = BVH_ANYHIT_TEST_OPS
MXU_RAY_SETUP_OPS = 15    # 9 products of phi, maxt check, miss selects
MXU_TEST_OPS = 158        # 4 x 16 FMAs (2 each), sign fold, guarded 1/|det|,
                          # t, hit, best update with u and v
MXU_TEST_FMAS = 64        # the FMAs among them
CLU_RAY_SETUP_OPS = CLU2_RAY_SETUP_OPS  # the same ray terms
SWEEP_RAY_SETUP_OPS = 15  # anchor shift, o x d, maxt check, final divide
SWEEP_TEST_OPS = 53       # the q test with a best pair of (t|det|, |det|)
DUAL_MERGE_OPS = 6        # two products, a compare, three selects
MACC_RAY_SETUP_OPS = SWEEP_RAY_SETUP_OPS + 2  # and u, v times 1/|det|
MACC_TEST_OPS = Q_TEST_OPS  # the sweep's test keeping u|det| and v|det|
MACC_MERGE_OPS = 12       # two products, three compares, two logic ops,
                          # five selects


def bessel_ops(half):
    # 64 Miller steps (~10 each), Hankel terms, normalisation
    return 64 * 10 + (half + 1) * 16 + 4


def lobe_sum_ops(half, separable, C):
    lobes = (2 * half + 1) if separable else (2 * half + 1) ** 2
    per_channel = 12 + bessel_ops(half) + 3 * half + lobes * 45 + 3
    return 20 + C * per_channel


def sample_ops(half, ndf):
    vndf = 150 if ndf == 1 else 45
    return vndf + 60 + 25 + bessel_ops(half) + 3 * half + 8 * (half + 1) \
        + 2 * (4 * (half + 1) + 6) + 2 * (half + 1) + 40 + 30 + 20


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_intersect(scene, n_rays, rng):
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    dev = scene.device
    geo = scene.geo
    W, H = scene.sensor.resolution
    spp = max(1, n_rays // (W * H))
    sampler = Sampler.create(0, W * H * spp, device=dev)
    ray, _ = sample_rays(scene, sampler, W, H, spp)
    o, d, maxt = ray.o, ray.d, ray.maxt
    n = o.shape[0]
    args = (geo.tri_q, geo.tri_anchor, o, d, maxt, geo.n_faces)

    # closest hit on the camera rays (maxt = inf)
    got = isect.intersect_q(*args)
    want = isect.intersect_q_plain(*args)
    torch.cuda.synchronize()
    prim_same = got[1] == want[1]
    frac_prim = prim_same.float().mean().item()
    both = prim_same & (want[1] >= 0)
    # tolerance: t, u, v at rtol 1e-5 (atol 1e-6 for t, 1e-5 for u, v) on
    # lanes that hit the same triangle; prim may differ only where a ray
    # meets a shared edge or a triangle boundary within float rounding (the
    # kernel contracts multiply-adds into FMAs, the plain version does not):
    # at most 1 lane in 10,000
    t_ok = frac_close(got[0][both], want[0][both], 1e-5, 1e-6)
    u_ok = frac_close(got[2][both], want[2][both], 1e-5, 1e-5)
    v_ok = frac_close(got[3][both], want[3][both], 1e-5, 1e-5)
    require(frac_prim >= 1 - 1e-4, f"intersect_q prim agreement {frac_prim}")
    require(min(t_ok, u_ok, v_ok) == 1.0,
            f"intersect_q t/u/v agreement {t_ok} {u_ok} {v_ok}")
    err = max((got[0][both] - want[0][both]).abs().max().item(),
              (got[2][both] - want[2][both]).abs().max().item(),
              (got[3][both] - want[3][both]).abs().max().item())
    ms = time_ms(lambda: isect.intersect_q(*args))
    plain_ms = time_ms(lambda: isect.intersect_q_plain(*args))
    bnd = bound(nbytes(geo.tri_q, geo.tri_anchor, o, d, maxt, got),
                n * (Q_RAY_SETUP_OPS + geo.n_faces * Q_TEST_OPS))
    closest = {"name": "intersect_q", "route": "cuda",
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1373 "
                           "(pallas_intersect_q)",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bnd, "library_ms": None,
               "n": n, "prim_agreement": frac_prim}

    # any hit on shadow-like rays: origins in the scene's box off every
    # surface, uniform directions, maxt uniform in [0, 6] with 10% inf and
    # 10% zero
    lo = np.array([-2.0, -0.45, -2.0]); hi = np.array([2.0, 1.5, 2.0])
    so = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    sd = rng.normal(size=(n, 3))
    sd = (sd / np.linalg.norm(sd, axis=-1, keepdims=True)).astype(np.float32)
    smt = rng.uniform(0.0, 6.0, n).astype(np.float32)
    pick = rng.random(n)
    smt[pick < 0.1] = np.inf
    smt[(pick >= 0.1) & (pick < 0.2)] = 0.0
    so, sd, smt = (torch.as_tensor(x, device=dev) for x in (so, sd, smt))
    sargs = (geo.tri_q, geo.tri_anchor, so, sd, smt, geo.n_faces)
    occ = isect.occluded_q(*sargs)
    occ_plain = isect.occluded_q_plain(*sargs)
    torch.cuda.synchronize()
    frac_occ = (occ == occ_plain).float().mean().item()
    # tolerance: equal except where t lies within float rounding of 0, maxt
    # or a triangle boundary: at most 1 lane in 10,000
    require(frac_occ >= 1 - 1e-4, f"occluded_q agreement {frac_occ}")
    # triangles tested per ray: up to the first hit (the loop leaves there)
    tested = km.anyhit_tests(geo.tri_q, geo.tri_anchor, so, sd, smt,
                             geo.n_faces)
    ms_a = time_ms(lambda: isect.occluded_q(*sargs))
    plain_a = time_ms(lambda: isect.occluded_q_plain(*sargs))
    bnd_a = bound(
        nbytes(geo.tri_q, geo.tri_anchor, so, sd, smt, occ),
        n * Q_RAY_SETUP_OPS + tested * Q_ANYHIT_TEST_OPS)
    anyhit = {"name": "occluded_q", "route": "cuda",
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
              "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1411 "
                          "(pallas_occluded_q)",
              "max_abs_err": 1.0 - frac_occ, "ms": ms_a, "plain_ms": plain_a,
              **bnd_a, "library_ms": None,
              "n": n, "occ_agreement": frac_occ}
    return [closest, anyhit]


def _rand_dir(rng, n):
    import numpy as np

    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def lobe_sum_inputs(rng, n, gtype, ip_y, dev):
    """Random lanes as in tests/test_grating_pallas.py."""
    import numpy as np
    import torch

    f32 = np.float32
    C = 3
    ins = dict(
        wi=_rand_dir(rng, n), wo=_rand_dir(rng, n),
        wl_nm=rng.uniform(380, 680, (n, C)).astype(f32),
        grating_dir=np.stack([np.ones(n), np.zeros(n)], -1).astype(f32),
        inv_period=np.stack([np.full(n, 2.0), np.full(n, ip_y)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7, 9], n).astype(np.int32),
        gtype=np.full(n, gtype, np.int32),
        multiplier=np.full(n, 1.3, f32),
        coherence=rng.uniform(1.0, 120.0, n).astype(f32),
        a_cone=rng.uniform(0.05, 0.4, n).astype(f32),
    )
    return {k: torch.as_tensor(v, device=dev) for k, v in ins.items()}


def check_lobe_sum(n, rng, dev):
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    # (half, separable, gtype, ip_y): the main path's case first, then the
    # three other cases of the CPU tests at a smaller lane count
    cases = [(3, True, 0, 0.0, n), (3, False, 0, 1.5, n // 16),
             (4, True, 1, 0.0, n // 16), (2, True, 2, 0.0, n // 16)]
    row = None
    for half, sep, gtype, ip_y, nn in cases:
        ins = lobe_sum_inputs(rng, nn, gtype, ip_y, dev)
        kw = dict(half=half, separable=sep)
        got = gops.grating_lobe_sum(**ins, **kw, n_channels=3)
        want = gops.grating_lobe_sum_plain(**ins, **kw)
        # tolerance: rtol 2e-3, atol 2e-5 (the CPU tests'); a lane may fall
        # outside only where a cone or grating-equation gate flips at float
        # rounding (FMA contraction): at most 1 lane in 100,000
        frac = frac_close(got, want, 2e-3, 2e-5)
        require(frac >= 1 - 1e-5,
                f"grating_lobe_sum {half, sep, gtype} agreement {frac}")
        if row is None:
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: gops.grating_lobe_sum(**ins, **kw,
                                                       n_channels=3))
            plain_ms = time_ms(lambda: gops.grating_lobe_sum_plain(**ins, **kw))
            bnd = contracted_bound(nbytes(ins, got),
                                   nn * lobe_sum_ops(half, sep, 3))
            row = {"name": "grating_lobe_sum", "route": "cuda",
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:230 "
                               "(grating_lobe_sum)",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bnd, "library_ms": None,
                   "n": nn, "agreement": frac}
    return row


def sample_inputs(rng, n, dev):
    import numpy as np
    import torch

    f32 = np.float32
    ins = dict(
        wi=_rand_dir(rng, n),
        u2=rng.uniform(0, 1, (n, 2)).astype(f32),
        lobe_u2=rng.uniform(0, 1, (n, 2)).astype(f32),
        wl_um=rng.uniform(0.38, 0.68, n).astype(f32),
        alpha=rng.uniform(0.03, 0.3, (n, 2)).astype(f32),
        grating_dir=np.stack([np.ones(n), np.zeros(n)], -1).astype(f32),
        inv_period=np.stack([np.full(n, 0.6), np.zeros(n)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7], n).astype(np.int32),
        gtype=np.zeros(n, np.int32),
        multiplier=np.full(n, 10.0, f32),
    )
    return {k: torch.as_tensor(v, device=dev) for k, v in ins.items()}


def check_sample(n, rng, dev):
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    row = None
    for ndf in (1, 0):  # Beckmann (the main path's NDF), then GGX
        ins = sample_inputs(rng, n, dev)
        got = gops.grating_sample(**ins, half=3, ndf=ndf)
        want = gops.grating_sample_plain(**ins, half=3, ndf=ndf)
        # tolerance (the CPU tests'): lobe and ok equal, wo and mvec at
        # rtol 1e-4 / atol 1e-5, pdf (clipped at 1e6) and G1 * intensity at
        # rtol 2e-3 / atol 1e-6, on lanes where both agree on the lobe and
        # are live; a lane may differ where u lies within float rounding of
        # a lobe-CDF step or a live/dead gate sits at its threshold: at
        # most 1 lane in 10,000
        same = (got["lobe"] == want["lobe"]).all(-1) & (got["ok"] == want["ok"])
        frac_same = same.float().mean().item()
        live = same & want["ok"]
        fr_wo = frac_close(got["wo"][live], want["wo"][live], 1e-4, 1e-5)
        fr_m = frac_close(got["mvec"], want["mvec"], 1e-4, 1e-5)
        fr_pdf = frac_close(torch.clamp_max(got["pdf"][live], 1e6),
                            torch.clamp_max(want["pdf"][live], 1e6),
                            2e-3, 1e-6)
        fr_w = frac_close(got["w_g1_int"][live], want["w_g1_int"][live],
                          2e-3, 1e-6)
        worst = min(frac_same, fr_wo, fr_m, fr_pdf, fr_w)
        require(worst >= 1 - 1e-4,
                f"grating_sample ndf={ndf} agreement lobe/ok {frac_same} "
                f"wo {fr_wo} mvec {fr_m} pdf {fr_pdf} w {fr_w}")
        if row is None:
            err = (got["wo"][live] - want["wo"][live]).abs().max().item()
            ms = time_ms(lambda: gops.grating_sample(**ins, half=3, ndf=ndf))
            plain_ms = time_ms(lambda: gops.grating_sample_plain(
                **ins, half=3, ndf=ndf))
            bnd = contracted_bound(nbytes(ins, got), n * sample_ops(3, ndf))
            row = {"name": "grating_sample", "route": "cuda",
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:593 "
                               "(grating_sample)",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bnd, "library_ms": None,
                   "n": n, "agreement": worst}
    return row


def hemisphere_rays(scene, p, ng, live, rng):
    """Bounce-like and shadow rays from surface points p [n, 3] with face
    normals ng (numpy): origins pushed off along ng as the integrator does,
    cosine-hemisphere directions about ng, and shadow rays to the scene's
    point light with maxt at its distance. Lanes that are not live get the
    integrator's canonical dead rays (o = 1e8, d = +z; shadow maxt 0)."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.core import math as m

    n = len(p)
    org = p + ng * m.RayEpsilon
    a = np.cross(ng, np.where(np.abs(ng[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                              [[1.0, 0.0, 0.0]]))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    bb = np.cross(ng, a)
    u1, u2 = rng.random(n), rng.random(n)
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    d = (a * (r * np.cos(phi))[:, None] + bb * (r * np.sin(phi))[:, None]
         + ng * np.sqrt(1 - u1)[:, None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to_l = scene.emitters.position[0].cpu().numpy().astype(np.float64) - org
    dist = np.linalg.norm(to_l, axis=-1)
    lv = live[:, None]
    dead_o, dead_d = np.full((n, 3), 1e8), np.array([[0.0, 0.0, 1.0]])
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                  device=scene.device)
    bounce = (t(np.where(lv, org, dead_o)), t(np.where(lv, d, dead_d)),
              t(np.full(n, np.inf)))
    shadow = (t(np.where(lv, org, dead_o)),
              t(np.where(lv, to_l / dist[:, None], dead_d)),
              t(np.where(live, dist * (1.0 - m.ShadowEpsilon), 0.0)))
    return bounce, shadow


def camera_hit_rays(scene, cam, hit, rng):
    """The rays of the path's first bounce, lane for lane: from the camera
    rays' hits (t, prim from intersect_clu2), dead where they missed."""
    import numpy as np

    t, prim = hit[0].cpu().numpy(), hit[1].cpu().numpy()
    live = prim >= 0
    o, d = cam.o.cpu().numpy(), cam.d.cpu().numpy()
    p = o + d * np.where(live, t, 0.0)[:, None]
    ng = scene.geo.tri_attr[:, 0:3].cpu().numpy()[np.maximum(prim, 0)]
    return hemisphere_rays(scene, p.astype(np.float64),
                           ng.astype(np.float64), live, rng)


def random_surface_rays(scene, n, rng):
    """Incoherent rays: from random points of random faces, every lane
    live (neighbouring lanes start far apart)."""
    import numpy as np

    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    mesh = make_sphere(MESH_SUBDIV)
    tri = mesh.faces[rng.integers(0, len(mesh.faces), n)]
    c = [mesh.vertices[tri[:, k]].astype(np.float64) for k in range(3)]
    ng = np.cross(c[1] - c[0], c[2] - c[0])
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    b1, b2 = rng.random(n), rng.random(n)
    flip = b1 + b2 > 1
    b1, b2 = np.where(flip, 1 - b1, b1), np.where(flip, 1 - b2, b2)
    p = c[0] + b1[:, None] * (c[1] - c[0]) + b2[:, None] * (c[2] - c[0])
    return hemisphere_rays(scene, p, ng, np.ones(n, bool), rng)


def check_clu2(scene, rng):
    """B5 and B6 against their plain versions on the mesh82k scene. Closest
    hit: the camera rays, the first bounce's rays from their hits, and
    incoherent rays from random surface points; any hit: the shadow rays
    of the first bounce and of the random points. The kernels line carries
    the path's own sets: camera rays (B5) and first-bounce shadow rays
    (B6). Returns (those two rows, the ray sets {label: (o, d, maxt)}, the
    kernels' ms on each {label: ms})."""
    import torch

    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    dev, ct = scene.device, scene.ctab2
    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(0, W * H * MESH_SPP_PASS,
                                               device=dev), W, H,
                         MESH_SPP_PASS)
    n = cam.o.shape[0]
    tables = (ct.supers, ct.boxes, ct.rows, ct.anchor)
    common = {"route": "cuda",
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_clu2.cu",
              "plain_timing": "the comparison call, once at full width",
              "library_ms": None,
              "n": n}

    def closest(label, o, d, mt):
        counts = {}
        got = isect.intersect_clu2(ct, o, d, mt)
        want, plain_ms = time_once(lambda: isect.intersect_clu2_plain(
            ct, o, d, mt, counts=counts))
        prim_same = got[1] == want[1]
        frac_prim = prim_same.float().mean().item()
        both = prim_same & (want[1] >= 0)
        # tolerance: t, u, v at rtol 1e-5 / atol 1e-6 on lanes that hit the
        # same triangle (the kernel rounds as the plain version does, so
        # these agree to the bit); prim may differ only where the plain
        # version's per-lane box gate rejects a hit on a box face within
        # float rounding: at most 1 lane in 10,000
        oks = [frac_close(got[k][both], want[k][both], 1e-5, 1e-6)
               for k in (0, 2, 3)]
        require(frac_prim >= 1 - 1e-4,
                f"intersect_clu2 {label} prim agreement {frac_prim}")
        require(min(oks) == 1.0, f"intersect_clu2 {label} t/u/v {oks}")
        err = max((got[k][both] - want[k][both]).abs().max().item()
                  if both.any() else 0.0 for k in (0, 2, 3))
        ms = time_ms(lambda: isect.intersect_clu2(ct, o, d, mt))
        ops = (n * CLU2_RAY_SETUP_OPS
               + (counts["super_tests"] + counts["cluster_tests"]) * SLAB_OPS
               + counts["triangle_tests"] * Q_TEST_OPS)
        bnd = bound(nbytes(tables, o, d, mt, got), ops)
        row = {"name": "intersect_clu2", **common,
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1352 "
                           "(pallas_intersect_clu2)",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bnd, "rays": label,
               "prim_agreement": frac_prim,
               "hit_share": (want[1] >= 0).float().mean().item(),
               "tests_per_ray": {k: v / n for k, v in counts.items()}}
        return row, got

    def anyhit(label, o, d, mt):
        counts = {}
        occ = isect.occluded_clu2(ct, o, d, mt)
        occ_plain, plain_ms = time_once(lambda: isect.occluded_clu2_plain(
            ct, o, d, mt, counts=counts))
        frac_occ = (occ == occ_plain).float().mean().item()
        # tolerance: equal except where t lies within float rounding of 0,
        # maxt or a box face: at most 1 lane in 10,000
        require(frac_occ >= 1 - 1e-4,
                f"occluded_clu2 {label} agreement {frac_occ}")
        ms = time_ms(lambda: isect.occluded_clu2(ct, o, d, mt))
        ops = (n * CLU2_RAY_SETUP_OPS
               + (counts["super_tests"] + counts["cluster_tests"]) * SLAB_OPS
               + counts["triangle_tests"] * Q_ANYHIT_TEST_OPS)
        bnd = bound(nbytes(tables, o, d, mt, occ), ops)
        return {"name": "occluded_clu2", **common,
                "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1364 "
                            "(pallas_occluded_clu2)",
                "max_abs_err": 1.0 - frac_occ, "ms": ms,
                "plain_ms": plain_ms, **bnd,
                "rays": label, "occ_agreement": frac_occ,
                "occluded_share": occ_plain.float().mean().item(),
                "tests_per_ray": {k: v / n for k, v in counts.items()}}

    cam_row, cam_hit = closest("camera", cam.o, cam.d, cam.maxt)
    sets = {"camera": (cam.o, cam.d, cam.maxt)}
    sets["bounce"], sets["shadow"] = camera_hit_rays(scene, cam, cam_hit, rng)
    sets["bounce-random"], sets["shadow-random"] = random_surface_rays(
        scene, n, rng)
    rows = {"camera": cam_row, "shadow": anyhit("shadow", *sets["shadow"])}
    for label in ("bounce", "bounce-random"):
        rows[label] = closest(label, *sets[label])[0]
    rows["shadow-random"] = anyhit("shadow-random", *sets["shadow-random"])
    for label in ("bounce", "bounce-random", "shadow-random"):
        emit({"phase": "kernels", **rows[label]})
    return ([rows["camera"], rows["shadow"]], sets,
            {label: r["ms"] for label, r in rows.items()})


def check_bvh(scene, sets, clu2_ms, rng):
    """B7a and B7b against their plain walks on the packet scene. First the
    five 1,048,576-lane mesh82k ray sets of `check_clu2`, unsorted and
    sorted by the route's coherence sort, with the sort's own time and the
    clu2 kernel's time on the same set beside them; then the wavefront the
    regenerative path gives the kernels: the 131,072 camera rays of its first
    iteration in Morton order and the shadow rays of their hits, sorted as
    the route sorts them. The kernels line carries the latter two."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import camera_rays_at
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    pb = scene.pbvh

    def sorted_rays(o, d, mt):
        """(the rays in the route's order, the permutation)."""
        perm, _ = scene._packet_perm(o, d)
        return (o[perm], d[perm], mt[perm]), perm

    def answer(any_hit, o, d, mt):
        """The wrapper's answer as one tensor: the flags, or prim."""
        if any_hit:
            return isect.occluded_bvh(pb, o, d, mt)
        return isect.intersect_bvh(pb, o, d, mt)[1]

    def one(label, any_hit, o, d, mt):
        """The kernel on (o, d, mt) as given: tolerance none, the kernel
        rounds every product and sum as the plain walk does, so prim, t, u,
        v and the occlusion flags are equal on every lane."""
        n, counts = o.shape[0], {}
        if any_hit:
            got = isect.occluded_bvh(pb, o, d, mt)
            want, plain_ms = time_once(lambda: isect.occluded_bvh_plain(
                pb, o, d, mt, counts=counts))
            agree = (got == want).double().mean().item()
            err = 1.0 - agree
            ms = time_ms(lambda: isect.occluded_bvh(pb, o, d, mt))
            share = {"occluded_share": want.float().mean().item()}
        else:
            got = isect.intersect_bvh(pb, o, d, mt)
            want, plain_ms = time_once(lambda: isect.intersect_bvh_plain(
                pb, o, d, mt, counts=counts))
            agree = (got[1] == want[1]).double().mean().item()
            hit = want[1] >= 0
            err = max((got[k][hit] - want[k][hit]).abs().max().item()
                      if hit.any() else 0.0 for k in (0, 2, 3))
            require(all(torch.equal(got[k], want[k]) for k in (0, 2, 3)),
                    f"intersect_bvh {label}: t/u/v differ, max {err}")
            ms = time_ms(lambda: isect.intersect_bvh(pb, o, d, mt))
            share = {"hit_share": hit.float().mean().item()}
        name = "occluded_bvh" if any_hit else "intersect_bvh"
        require(agree == 1.0, f"{name} {label}: agreement {agree}")
        ops = (n * BVH_RAY_SETUP_OPS + counts["slab_tests"] * SLAB_OPS
               + counts["triangle_tests"]
               * (BVH_ANYHIT_TEST_OPS if any_hit else BVH_TEST_OPS))
        bnd = bound(nbytes(pb.nodes, pb.tri, o, d, mt, got), ops)
        return {"name": name, "route": "cuda", "n": n,
                "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_bvh.cu",
                "plain_timing": "the comparison call, once",
                "library_ms": None,
                "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:"
                            + ("694 (pallas_bvh_occluded)" if any_hit
                               else "679 (pallas_bvh_intersect)"),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bnd, "rays": label,
                "agreement": agree, **share, "walk_steps": counts["steps"],
                "tests_per_ray": {k: counts[k] / n for k in
                                  ("slab_tests", "triangle_tests")}}

    for label, (o, d, mt) in sets.items():
        any_hit = label.startswith("shadow")
        row = one(label, any_hit, o, d, mt)
        in_order, perm = sorted_rays(o, d, mt)
        require(torch.equal(answer(any_hit, *in_order),
                            answer(any_hit, o, d, mt)[perm]),
                f"{row['name']} {label}: sorted and unsorted rays differ")
        emit({"phase": "kernels", **row, "order": "unsorted",
              "sorted_ms": time_ms(lambda: answer(any_hit, *in_order)),
              "packet_perm_ms": time_ms(lambda: scene._packet_perm(o, d)),
              "gather_ms": time_ms(lambda: (o[perm], d[perm], mt[perm])),
              "clu2_ms": clu2_ms[label]})

    # the regenerative path's own wavefront
    W, H = scene.sensor.resolution
    n = W * H * MESH_SPP_PASS // 8
    cam, _ = camera_rays_at(scene, 0, torch.arange(n, device=scene.device),
                            W, H, MESH_SPP_PASS, "morton")
    hit = isect.intersect_bvh(pb, cam.o, cam.d, cam.maxt)
    _, shadow = camera_hit_rays(scene, cam, hit, rng)
    return [one("regen camera, sorted", False,
                *sorted_rays(cam.o, cam.d, cam.maxt)[0]),
            one("regen shadow, sorted", True, *sorted_rays(*shadow)[0])]


def check_brute(label, scene, sets, plain_lanes=None):
    """B8a, B8b and B9 against their plain versions on the tool's ray sets
    {set: (o, d, maxt)} of one scene: on the first `plain_lanes` lanes (all
    where None), timed on all. B8 must equal its plain version to the bit;
    B9's hit masks and prims must agree on >= 99.99% of lanes and t within
    rtol 1e-4 where both hit. Returns {set: [B8a row, B8b row, B9 row]}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    geo, F = scene.geo, scene.geo.n_faces
    p = geo.tri_isect[:F].cpu().numpy()
    w = torch.as_tensor(isect.regroup_tri_mxu(isect.pack_tri_mxu(
        p[:, 0:3], p[:, 3:6], p[:, 6:9])), device=scene.device)
    nt = isect._closest_rows(geo.tri_isect, F)
    out = {}
    for set_label, (o, d, mt) in sets.items():
        n = o.shape[0]
        m = n if plain_lanes is None else min(n, plain_lanes)
        part = (o[:m], d[:m], mt[:m])
        common = {"route": "cuda", "n": n, "plain_lanes": m,
                  "rays": f"{label} {set_label}", "library_ms": None,
                  "plain_timing": "the comparison call, once, on plain_lanes"}

        # B8a: closest hit, equal to the bit
        got = isect.intersect_classic(geo.tri_isect, *part, F)
        want, plain_ms = time_once(lambda: isect.intersect_classic_plain(
            geo.tri_isect, *part, F))
        hit = want[1] >= 0
        err = max((got[k][hit] - want[k][hit]).abs().max().item()
                  if hit.any() else 0.0 for k in (0, 2, 3))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"intersect_classic {label} {set_label}: differs, max {err}")
        ms = time_ms(lambda: isect.intersect_classic(geo.tri_isect, o, d, mt,
                                                     F))
        bnd = bound(nbytes(geo.tri_isect[:nt], o, d, mt) + 16 * n,
                    n * (CLASSIC_RAY_SETUP_OPS + nt * CLASSIC_TEST_OPS))
        closest = {"name": "intersect_classic", **common,
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/"
                             "intersect_classic.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:95 "
                               "(pallas_intersect)",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bnd, "agreement": 1.0,
                   "hit_share": hit.float().mean().item()}

        # B8b: any hit, equal to the bit; the tests a thread makes (up to
        # its first hit) counted on the compared lanes, scaled to n
        counts = {}
        occ = isect.occluded_classic(geo.tri_isect, *part, F)
        occ_plain, plain_a = time_once(lambda: isect.occluded_classic_plain(
            geo.tri_isect, *part, F, counts=counts))
        agree = (occ == occ_plain).double().mean().item()
        require(torch.equal(occ, occ_plain),
                f"occluded_classic {label} {set_label}: agreement {agree}")
        ms_a = time_ms(lambda: isect.occluded_classic(geo.tri_isect, o, d, mt,
                                                      F))
        tests = counts["triangle_tests"] * n / m
        bnd_a = bound(nbytes(geo.tri_isect[:F], o, d, mt) + n,
                      n * CLASSIC_RAY_SETUP_OPS
                      + tests * CLASSIC_ANYHIT_TEST_OPS)
        anyhit = {"name": "occluded_classic", **common,
                  "source": "mitsuba3_plt_tpu_torch/ops/csrc/"
                            "intersect_classic.cu",
                  "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:183 "
                              "(pallas_occluded)",
                  "max_abs_err": 1.0 - agree, "ms": ms_a, "plain_ms": plain_a,
                  **bnd_a, "agreement": agree,
                  "occluded_share": occ_plain.float().mean().item(),
                  "tests_per_ray": tests / n}

        # B9: the MXU form, within its tolerance
        got_m = isect.intersect_mxu(w, *part, F)
        want_m, plain_m = time_once(lambda: isect.intersect_mxu_plain(
            w, *part, F))
        mhit, whit = got_m[1] >= 0, want_m[1] >= 0
        hit_agree = (mhit == whit).double().mean().item()
        prim_agree = (got_m[1] == want_m[1]).double().mean().item()
        both = mhit & whit
        t_off = int(((got_m[0][both] - want_m[0][both]).abs()
                     > 1e-4 * want_m[0][both].abs()).sum())
        require(min(hit_agree, prim_agree) >= 1 - 1e-4 and t_off == 0,
                f"intersect_mxu {label} {set_label}: hit {hit_agree} prim "
                f"{prim_agree}, {t_off} lanes beyond t rtol 1e-4")
        same = (got_m[1] == want_m[1]) & mhit
        err_m = max((got_m[k][same] - want_m[k][same]).abs().max().item()
                    if same.any() else 0.0 for k in (0, 2, 3))
        ms_m = time_ms(lambda: isect.intersect_mxu(w, o, d, mt, F))
        # the work of the mesh's F triangles: the zero rows that pad each
        # group to T_pad are the TPU's tile, and the kernel skips them
        t_pad = w.shape[0] // 4
        w_f = w.view(4, t_pad, 16)[:, :F].reshape(4 * F, 16)
        bnd_m = bound(nbytes(w_f, o, d, mt) + 16 * n,
                      n * (MXU_RAY_SETUP_OPS + F * MXU_TEST_OPS),
                      n * F * MXU_TEST_FMAS)
        k = n if plain_lanes is None else min(n, isect.MXU_CHUNK)
        phi = isect.mxu_features(o[:k], d[:k])
        mm_ms = time_ms(lambda: torch.matmul(phi, w_f.T), reps=3, calls=3)
        del phi
        mxu = {"name": "intersect_mxu", **common,
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_mxu.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:346 "
                           "(pallas_intersect_mxu)",
               "max_abs_err": err_m, "ms": ms_m, "plain_ms": plain_m,
               **bnd_m, "t_pad": t_pad, "n_tris": F,
               "hit_agreement": hit_agree, "prim_agreement": prim_agree,
               "matmul_ms": mm_ms, "matmul_lanes": k,
               "vs_classic": bi.agreement(got, got_m)}
        out[set_label] = [closest, anyhit, mxu]
        for r in out[set_label]:
            emit({"phase": "kernels", **r})
        del got, want, got_m, want_m
    return out


def check_clu(label, tabs, sets, plain_lanes):
    """B10a and B10b against their plain versions over the mask-sort
    tool's ctab64 on its ray sets {set: (o, d, maxt)}: the closest hit on
    the non-shadow sets, the any hit on the shadow sets, each equal to the
    plain version to the bit on `plain_lanes` lanes spread evenly over the
    set (the sets are in image order; the kernel gates each lane on its
    own, as the plain version does) and timed on all. The bound counts
    each ray's own slab and triangle tests (the plain version's counts,
    scaled to all lanes). Returns {set: row}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    ct = tabs["ctab64"]
    tables = (ct.boxes, ct.rows, ct.anchor)
    out = {}
    for set_label, (o, d, mt) in sets.items():
        any_hit = set_label.startswith("shadow")
        n = o.shape[0]
        step = max(1, n // plain_lanes)
        part = tuple(x[::step].contiguous() for x in (o, d, mt))
        m = part[0].shape[0]
        counts = {}
        kernel = isect.occluded_clu if any_hit else isect.intersect_clu
        plain = (isect.occluded_clu_plain if any_hit
                 else isect.intersect_clu_plain)
        got = kernel(ct, *part)
        want, plain_ms = time_once(lambda: plain(ct, *part, counts=counts))
        name = "occluded_clu" if any_hit else "intersect_clu"
        if any_hit:
            agree = (got == want).double().mean().item()
            require(torch.equal(got, want),
                    f"{name} {label} {set_label}: agreement {agree}")
            err = 1.0 - agree
            share = {"occluded_share": want.double().mean().item()}
            out_bytes = n
        else:
            hit = want[1] >= 0
            err = max((got[k][hit] - want[k][hit]).abs().max().item()
                      if hit.any() else 0.0 for k in (0, 2, 3))
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"{name} {label} {set_label}: differs, max {err}")
            share = {"hit_share": hit.double().mean().item()}
            out_bytes = 16 * n
        ms = time_ms(lambda: kernel(ct, o, d, mt))
        scale = n / m
        ops = (n * CLU_RAY_SETUP_OPS
               + counts["cluster_tests"] * scale * SLAB_OPS
               + counts["triangle_tests"] * scale
               * (Q_ANYHIT_TEST_OPS if any_hit else Q_TEST_OPS))
        bnd = bound(nbytes(tables, o, d, mt) + out_bytes, ops)
        row = {"name": name, "route": "cuda", "n": n, "plain_lanes": m,
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_clu.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:"
                           + ("1093 (pallas_occluded_clu)" if any_hit
                              else "1080 (pallas_intersect_clu)"),
               "rays": f"{label} {set_label}", "library_ms": None,
               "plain_timing": "the comparison call, once, on plain_lanes",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bnd, "agreement": 1.0 - err
               if any_hit else 1.0, **share, "boxes": ct.boxes.shape[0],
               "tests_per_ray": {k: v / m for k, v in counts.items()}}
        emit({"phase": "kernels", **row})
        out[set_label] = row
        del got, want
    return out


def check_sweep(label, scene, rays, plain_lanes=None):
    """B11a at every unroll, with one and with two accumulators, and B11b
    at every unroll against their plain versions on the sweep's rays, equal
    to the bit on the first `plain_lanes` lanes (all where None), timed on
    all. The closest hit runs with maxt inf. The any hit is timed and
    bounded on the tool's maxt (0.99 of B1's t where B1 hits, else 2.0: no
    lane is occluded, every lane tests every row) and checked on a mixed
    one (0.99 or 1.01 of B1's t on alternate lanes, inf on every third
    lane) so that lanes stop at a hit and the inf rule is held. A plain
    version depends on the unroll only through the rows it runs, so it is
    run once per row count. Returns {(kind, unroll, dual): row}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    geo, F = scene.geo, scene.geo.n_faces
    q = (geo.tri_q, geo.tri_anchor)
    o, d, mt = rays
    n = o.shape[0]
    m = n if plain_lanes is None else min(n, plain_lanes)
    t0 = isect.intersect_q(*q, o, d, mt, F)[0]
    msh = torch.where(torch.isfinite(t0), t0 * 0.99, 2.0)
    lane = torch.arange(m, device=o.device)
    mix = torch.where(torch.isfinite(t0[:m]),
                      t0[:m] * torch.where(lane % 2 == 0, 0.99, 1.01), 2.0)
    mix = torch.where(lane % 3 == 0, float("inf"), mix)
    del t0
    common = {"route": "cuda", "n": n, "plain_lanes": m,
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_sweep.cu",
              "rays": f"{label} sweep", "library_ms": None,
              "plain_timing": "the comparison call, once, on plain_lanes"}
    plain, out = {}, {}
    for unroll in isect.Q_VARIANT_UNROLLS:
        rows = isect.q_variant_rows(geo.tri_q.shape[0], F, unroll)
        for dual in (False, True):
            got = isect.intersect_q_variant(*q, o[:m], d[:m], mt[:m], F,
                                            unroll, dual)
            if (rows, dual) not in plain:
                plain[rows, dual] = time_once(
                    lambda: isect.intersect_q_variant_plain(
                        *q, o[:m], d[:m], mt[:m], F, unroll, dual))
            want, plain_ms = plain[rows, dual]
            hit = want[1] >= 0
            err = ((got[0][hit] - want[0][hit]).abs().max().item()
                   if hit.any() else 0.0)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"intersect_q_variant {label} unroll {unroll} dual "
                    f"{dual}: differs, max {err}")
            ms = time_ms(lambda: isect.intersect_q_variant(
                *q, o, d, mt, F, unroll, dual))
            bnd = bound(
                nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, mt) + 8 * n,
                n * (SWEEP_RAY_SETUP_OPS + rows * SWEEP_TEST_OPS
                     + (DUAL_MERGE_OPS if dual else 0)))
            out["closest", unroll, dual] = {
                "name": "intersect_q_variant", **common,
                "replaces": "tools/experiments/isect_unroll_sweep.py:91 "
                            "(q_variant)",
                "unroll": unroll, "dual": dual, "rows": rows,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bnd, "agreement": 1.0,
                "hit_share": hit.double().mean().item()}
        occ = isect.occluded_q_variant(*q, o[:m], d[:m], mix, F, unroll)
        if rows not in plain:
            plain[rows] = time_once(lambda: isect.occluded_q_variant_plain(
                *q, o[:m], d[:m], mix, F, unroll))
        want, plain_ms = plain[rows]
        agree = (occ == want).double().mean().item()
        require(torch.equal(occ, want) and want.any()
                and not want[::3].any(),
                f"occluded_q_variant {label} unroll {unroll}: {agree}")
        ms = time_ms(lambda: isect.occluded_q_variant(*q, o, d, msh, F,
                                                      unroll))
        if ("tests", rows) not in plain:
            plain["tests", rows] = km.anyhit_tests(
                *q, o[:m], d[:m], msh[:m], rows) * n / m
        tests = plain["tests", rows]
        bnd = bound(
            nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, msh) + n,
            n * SWEEP_RAY_SETUP_OPS + tests * Q_ANYHIT_TEST_OPS)
        out["any hit", unroll, False] = {
            "name": "occluded_q_variant", **common,
            "replaces": "tools/experiments/isect_unroll_sweep.py:203 "
                        "(a_variant)",
            "unroll": unroll, "dual": False, "rows": rows,
            "max_abs_err": 1.0 - agree, "ms": ms, "plain_ms": plain_ms,
            **bnd, "agreement": agree,
            "checked_occluded_share": want.double().mean().item(),
            "tests_per_ray": tests / n}
    for r in out.values():
        emit({"phase": "kernels", **r})
    return out


def check_macc(label, scene, rays, plain_lanes=None):
    """B11c at every nacc against its plain version on the
    multi-accumulator tool's rays (maxt inf), equal to the bit (t, prim, u,
    v) on the first `plain_lanes` lanes (all where None), timed on all.
    Returns {nacc: row}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    geo, F = scene.geo, scene.geo.n_faces
    q = (geo.tri_q, geo.tri_anchor)
    o, d, mt = rays
    n = o.shape[0]
    m = n if plain_lanes is None else min(n, plain_lanes)
    rows = isect.q_variant_rows(geo.tri_q.shape[0], F, isect.Q_MACC_UNROLL)
    out = {}
    for nacc in isect.Q_MACC_NACCS:
        got = isect.intersect_q_macc(*q, o[:m], d[:m], mt[:m], F, nacc)
        want, plain_ms = time_once(lambda: isect.intersect_q_macc_plain(
            *q, o[:m], d[:m], mt[:m], F, nacc))
        hit = want[1] >= 0
        err = max((got[k][hit] - want[k][hit]).abs().max().item()
                  if hit.any() else 0.0 for k in (0, 2, 3))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"intersect_q_macc {label} nacc {nacc}: differs, max {err}")
        ms = time_ms(lambda: isect.intersect_q_macc(*q, o, d, mt, F, nacc))
        bnd = bound(
            nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, mt) + 16 * n,
            n * (MACC_RAY_SETUP_OPS + rows * MACC_TEST_OPS
                 + (nacc - 1) * MACC_MERGE_OPS))
        out[nacc] = {
            "name": "intersect_q_macc", "route": "cuda", "n": n,
            "plain_lanes": m,
            "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_sweep.cu",
            "replaces": "tools/experiments/isect_q_multiacc.py:100 "
                        "(intersect_macc)",
            "rays": f"{label} multiacc", "library_ms": None,
            "plain_timing": "the comparison call, once, on plain_lanes",
            "nacc": nacc, "rows": rows, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **bnd, "agreement": 1.0,
            "hit_share": hit.double().mean().item()}
        emit({"phase": "kernels", **out[nacc]})
        del got, want
    return out


def check_fma(rng, dev):
    """B11d against its plain version at the probe's 8,192 x 128, on random
    x in [0.5, 2) and a in [0.98, 1.02) (a per row of the tile and lane)
    with some chains driven into the 3e38 clamp: within 1 ulp an element
    (the plain version forms x a + c in float64 and rounds it once more).
    Timed on the same inputs (an FFMA's time does not depend on its
    values)."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.ops import mfu
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    x = rng.uniform(0.5, 2.0, (km.FMA_ROWS, mfu.LANES)).astype(np.float32)
    a = rng.uniform(0.98, 1.02, (mfu.SUB, mfu.LANES)).astype(np.float32)
    x[3, :8] = 1e38
    a[5, :4] = 1.5
    x, a = (torch.as_tensor(v, device=dev) for v in (x, a))
    got = mfu.fma_roof(x, a)
    want, plain_ms = time_once(lambda: mfu.fma_roof_plain(x, a))
    ulps = (got.view(torch.int32).long() - want.view(torch.int32)).abs()
    max_ulp = int(ulps.max())
    fin = torch.isfinite(want)
    require(max_ulp <= 1 and torch.equal(fin, torch.isfinite(got))
            and bool((~fin).any()), f"fma_roof: {max_ulp} ulp")
    ms = time_ms(lambda: mfu.fma_roof(x, a))
    n = x.numel()
    # per element: FMA_ITERS + 3 FMAs (2 each), FMA_ITERS mins, 3 adds
    fmas = mfu.FMA_ITERS + 3
    bnd = bound(nbytes(x, a, got), n * (2 * fmas + mfu.FMA_ITERS + 3),
                n * fmas)
    row = {"name": "fma_roof", "route": "cuda", "n": n,
           "source": "mitsuba3_plt_tpu_torch/ops/csrc/fma_roof.cu",
           "replaces": "tools/experiments/kernel_mfu.py:79 (vpu_fma_roof)",
           "library_ms": None, "plain_timing": "the comparison call, once",
           "max_abs_err": (got[fin] - want[fin]).abs().max().item(),
           "max_ulp": max_ulp, "ulp_share": (ulps > 0).double().mean().item(),
           "ms": ms, "plain_ms": plain_ms, **bnd}
    emit({"phase": "kernels", **row})
    return row


def mask_sort_tool(scenes):
    """The cluster-mask sort tool on each (label, scene, tables, ray sets):
    the launches of one run on the Cornell box's depth1 and shadow1 sets,
    then per scene each sorted and Morton pipeline held to the unsorted
    kernel over the same table on every lane of every set, and one timed
    run, a row per route and set. Each cluster route agrees with q on >=
    99.99% of lanes (the JAX tool's check) on the JAX tool's sets (camera,
    bounce and shadow rays); on the incoherent set, whose origins lie
    inside the Cornell box's boxes, the bottoms and the floor are coplanar
    and tie exactly, and the first in table order wins, so there >= 99.99%
    of lanes must have the same prim or their hit at the same distance.
    Returns the launches."""
    import torch

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms

    ph = Phase("mask-sort")
    _, cscene, ctabs, csets = scenes[0]
    pick = {k: csets[k] for k in ("depth1", "shadow1")}
    ops.reset_launch_counts()
    ms.run(cscene, pick, tabs=ctabs)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1, "occluded_q": 1,
            "intersect_clu": 4, "occluded_clu": 4}
    require(launches == want, f"mask-sort launches {launches}")
    n_rows = 0
    for label, scene, tabs, sets in scenes:
        fns = ms.route_fns(scene, tabs)
        unsorted = {"m64": fns["clu"],
                    "m128": (ms._clu_fn(tabs["ctab128"], False),
                             ms._clu_fn(tabs["ctab128"], True)),
                    "clu-morton": fns["clu"]}
        for set_label, (o, d, mt) in sets.items():
            any_hit = set_label.startswith("shadow")
            for name, base in unsorted.items():
                got = fns[name][any_hit](o, d, mt)
                ref = base[any_hit](o, d, mt)
                same = (torch.equal(got, ref) if any_hit else
                        all(torch.equal(a, b) for a, b in zip(got, ref)))
                require(same, f"mask-sort {label} {set_label} {name}: "
                              "differs from the unsorted kernel")
        rows = ms.run(scene, sets, tabs=tabs,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "mask-sort", "scene": label, **r})
            agree = (r["occ_agree"] if r["kind"] == "any hit"
                     else r["same_hit"] if r["set"] == "incoherent"
                     else r["prim_agree"])
            require(agree >= 0.9999, f"mask-sort {label} {r['set']} "
                                     f"{r['route']}: agreement {agree}")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches,
            boxes={label: {k: t.boxes.shape[0] for k, t in tabs.items()}
                   for label, _, tabs, _ in scenes})
    return launches


def unroll_sweep_tool(scenes):
    """The unroll-sweep tool on each (label, scene, rays): the launches of
    one run on the Cornell box's rays, then one timed run per scene, a row
    per variant with its agreement with B1 or B2. Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    ph = Phase("unroll-sweep")
    _, cscene, crays = scenes[0]
    ops.reset_launch_counts()
    us.run(cscene, crays)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1, "occluded_q": 1,
            "intersect_q_variant": len(us.CLOSEST),
            "occluded_q_variant": len(us.ANYHIT)}
    require(launches == want, f"unroll-sweep launches {launches}")
    n_rows = 0
    for label, scene, rays in scenes:
        rows = us.run(scene, rays,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "unroll-sweep", "scene": label, **r})
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches)
    return launches


def q_multiacc_tool(scenes):
    """The multi-accumulator tool on each (label, scene, rays): the
    launches of one run on the Cornell box's rays, then one timed run per
    scene, a row per nacc with its prim agreement with B1, >= 0.99 (an
    exact tie across groups goes to the lower group, B1 takes the first
    row). Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_q_multiacc as qm

    ph = Phase("q-multiacc")
    _, cscene, crays = scenes[0]
    ops.reset_launch_counts()
    qm.run(cscene, crays)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1,
            "intersect_q_macc": len(qm.NACCS)}
    require(launches == want, f"q-multiacc launches {launches}")
    n_rows = 0
    for label, scene, rays in scenes:
        rows = qm.run(scene, rays,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "q-multiacc", "scene": label, **r})
            require(r["prim_agree"] >= 0.99,
                    f"q-multiacc {label} nacc {r['nacc']}: {r['prim_agree']}")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches)
    return launches


def kernel_mfu_tool(q_scenes, dev):
    """The MFU tool: B11d's SASS (one FFMA and one FMNMX a chain a step,
    required), then one timed run of every probe, its launches counted
    outside the timers (each probe's own first call): the FMA probe chained
    at the JAX tool's 8,192 rows and at FMA_WIDE_ROWS (a grid of ~31
    waves, against ~4 whose last is partial), the HBM probe's roll chained
    and a copy, B1/B2 on each (label, scene, rays) of q_scenes, B5 on
    mesh_scene(1024, 1024, 6), B4 on the JAX tool's inputs; a row each
    against the measured and the published roofs. Returns (the launches,
    the measured roofs)."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.ops import mfu
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    ph = Phase("kernel-mfu")
    sass = mfu.fma_roof_sass()
    require(sass["ffma"] == mfu.FMA_ITERS + 3
            and sass["fmnmx"] == mfu.FMA_ITERS, f"fma_roof SASS {sass}")
    mscene, bvh = km.clu2_setup(dev)
    timed = {k: 0 for k in NO_LAUNCHES}

    def untallied(measure):
        def run(*args):
            before = ops.launch_counts()
            ms = measure(*args)
            for k, v in ops.launch_counts().items():
                timed[k] += v - before[k]
            return ms
        return run

    timer = untallied(lambda fn: time_ms(fn, reps=3, calls=3, warmup=1))
    chained = untallied(chained_ms)
    ops.reset_launch_counts()
    rows = [km.fma_roof_probe(dev, chained, sass),
            km.fma_roof_probe(dev, chained, sass, FMA_WIDE_ROWS),
            km.hbm_probe(dev, chained, timer)]
    for label, scene, rays in q_scenes:
        rows += [dict(r, scene=label) for r in km.q_probe(scene, rays, timer)]
    rows.append(km.clu2_probe(mscene, bvh, timer))
    rows.append(km.lobe_sum_probe(dev, timer))
    launches = {k: v - timed[k] for k, v in ops.launch_counts().items()}
    want = {**NO_LAUNCHES, "fma_roof": 2, "intersect_q": len(q_scenes),
            "occluded_q": len(q_scenes), "intersect_clu2": 1,
            "grating_lobe_sum": 1}
    require(launches == want, f"kernel-mfu launches {launches}")
    roofs = km.roofs(rows[:2], rows[2])
    # the lobe sum against the roofs by chip_smoke's operation count (an FMA
    # two operations, two FLOP), its slots the floor of contracted_bound
    lobe = rows[-1]
    lobe["flop"] = lobe["n"] * lobe_sum_ops(km.LOBE_HALF, True, 3)
    lobe["slots_floor"] = lobe["flop"] // 2
    lobe["flop_per_s"] = lobe["flop"] / lobe["ms"] * 1e3
    lobe["slots_per_s"] = lobe["slots_floor"] / lobe["ms"] * 1e3
    for r in rows:
        emit({"phase": "kernel-mfu", **km.shares(r, roofs)})
    require(rows[0]["finite"] and rows[1]["finite"] and rows[2]["correct"]
            and rows[-1]["finite"] and rows[-2]["hit_share"] > 0,
            "kernel-mfu: a probe's output is wrong")
    ph.emit(roofs=roofs, sass=sass, launches_one_run=launches,
            fma_roof_tflops=roofs["flops"] / 1e12,
            slot_roof_tslots=roofs["slots"] / 1e12,
            hbm_tb_per_s=roofs["bytes"] / 1e12)
    return launches, roofs


def isect_tool(scenes):
    """The intersection tool on each (label, scene, ray sets): the launches
    of one run on one set (the Cornell box's first bounce), then one timed
    run per scene, a row per route and set. Every closest-hit route must
    agree with brute-classic on hit or miss on >= 99.9% of lanes, every
    any-hit route on >= 99% (shadow rays start 1e-4 off a surface, where
    the q and classic forms round t = 0 apart). Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    ph = Phase("isect-tool")
    _, cscene, csets = scenes[0]
    ops.reset_launch_counts()
    bi.run(cscene, {"depth1": csets["depth1"]})
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_classic": 1, "occluded_classic": 1,
            "intersect_mxu": 1, "intersect_q": 1, "occluded_q": 1,
            "intersect_bvh": 2}
    require(launches == want, f"isect-tool launches {launches}")
    n_rows = 0
    for label, scene, sets in scenes:
        rows = bi.run(scene, sets,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3, warmup=1))
        for r in rows:
            emit({"phase": "isect-tool", "scene": label, **r})
            worst = r["occ_agree"] if r["route"] in bi.ANYHIT else \
                r["hit_agree"]
            require(worst >= (0.99 if r["route"] in bi.ANYHIT else 0.999),
                    f"isect-tool {label} {r['set']} {r['route']}: {worst}")
        require({(r["set"], r["route"]) for r in rows} == {
            (s_, r_) for s_ in sets for r_ in bi.ROUTES
            if r_ in bi.ANYHIT or not s_.startswith("shadow")},
            f"isect-tool {label}: a route or a set is missing")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_set=launches)
    return launches


# ---------------------------------------------------------------------------
# golden images, main paths and their device-time split
# ---------------------------------------------------------------------------

def golden_ztest(name, scene, integ, golden, spp_per_seed):
    """Render 4 seeds and z-test their mean against a golden image."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name)
    ref = np.load(os.path.join(HERE, "tests", "golden", golden))
    imgs = np.stack([render(scene, integ, seed=s,
                            spp=spp_per_seed).cpu().numpy()
                     for s in range(4)])
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    sigma = np.sqrt((var + ref["var"]) / 4 + 1e-8)
    z = np.abs(mean - ref["mean"]) / sigma
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    thresh = -torch.special.ndtri(
        torch.tensor(alpha / 2, dtype=torch.float64)).item()
    n_fail = int((z > thresh).sum())
    ph.emit(pixels=int(z.size), fail=n_fail, max_z=float(z.max()),
            thresh=thresh, mean=float(mean.mean()),
            ref_mean=float(ref["mean"].mean()))
    require(n_fail == 0, f"{name} z-test: {n_fail} pixels fail")


def main_path(name, scene, integ, spp_pass, per_pass, **render_kw):
    """One warm-up pass, then TIMED_PASSES timed passes; per_pass gives the
    launches each kernel must make in a pass (ITER: one per iteration of
    the regenerative loop, which must run at least max_depth times a pass).
    Returns (the printed fields, the image)."""
    import torch

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name)
    W, H = scene.sensor.resolution
    warm = {}
    render(scene, integ, seed=0, spp=spp_pass, spp_per_pass=spp_pass,
           stats=warm, **render_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    spp = spp_pass * TIMED_PASSES
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    img = render(scene, integ, seed=1, spp=spp, spp_per_pass=spp_pass,
                 stats=stats, **render_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    res = {"width": W, "height": H, "max_depth": integ.max_depth,
           "rr_depth": integ.rr_depth, "spp": spp, "spp_per_pass": spp_pass,
           "lanes_per_pass": stats["lanes_per_pass"],
           "iterations_per_pass": stats["regen_iterations"], **render_kw,
           "warmup_pass_s": warm["pass_s"][0], "pass_s": stats["pass_s"],
           "wall_s": wall, "camera_samples_per_s": W * H * spp / wall,
           "ms_per_spp": wall * 1e3 / spp, "peak_mem_bytes": peak,
           "launches": launches, "image_mean": mean, "finite": finite}
    ph.emit(**res)
    require(finite and mean > 0, f"{name} image not finite and non-zero")
    iters = stats["regen_iterations"]
    if ITER in per_pass.values():
        require(len(iters) == TIMED_PASSES
                and min(iters) >= integ.max_depth,
                f"{name}: regenerative iterations per pass {iters}")
    for kname, count in launches.items():
        want = (sum(iters) if per_pass[kname] == ITER
                else per_pass[kname] * TIMED_PASSES)
        require(count == want,
                f"{name}: {kname} launched {count} times, expected {want}")
    return res, img


def same_image(name, img, scene, integ, spp_pass):
    """A regenerative Morton-order image against the fixed-depth renders of
    the same seed: equal to the one in Morton order (the same samples in
    another schedule; rtol 2e-5 / atol 2e-6, the film sums in another
    order), and equal to noise to the scanline one (other samples per
    pixel): means within 1%."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name + "-image")
    kw = dict(seed=1, spp=spp_pass * TIMED_PASSES, spp_per_pass=spp_pass)
    fixed = render(scene, integ, pixel_order="morton", **kw)
    scan = render(scene, integ, **kw)
    close = torch.isclose(img, fixed, rtol=2e-5, atol=2e-6)
    mean_gap = abs(img.mean().item() / scan.mean().item() - 1.0)
    ph.emit(max_abs_diff=(img - fixed).abs().max().item(),
            close_share=close.float().mean().item(),
            scanline_mean_gap=mean_gap,
            scanline_mean_abs_diff=(img - scan).abs().mean().item(),
            image_mean=img.mean().item())
    require(bool(close.all()), f"{name}: differs from the fixed-depth render")
    require(mean_gap < 0.01, f"{name}: mean differs from the scanline render")


def split(name, scene, integ, pass_s, spp_pass, out_file, **render_kw):
    """Device time of one main-path pass by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(scene, integ, seed=2, spp=spp_pass, spp_per_pass=spp_pass,
               **render_kw)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # kernel-level events only: an aten op's row repeats the device
        # time of the kernels it launched
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": ev.key, "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    # clu2_kernel first: "q_kernel" must not take its rows
    ours = {"clu2_kernel": 0.0, "bvh_kernel": 0.0, "q_kernel": 0.0,
            "lobe_sum_kernel": 0.0, "sample_kernel": 0.0}
    n_kernels = 0
    for r in rows:
        for key in ours:
            if key in r["name"]:
                ours[key] += r["device_ms"]
                break
        n_kernels += r["count"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_file), "w") as f:
        json.dump({"pass_wall_ms": pass_s * 1e3, "device_ms": total,
                   "ops": rows}, f, indent=1)
    ph.emit(pass_wall_ms=pass_s * 1e3, device_busy_ms=total,
            device_idle_share=(1.0 - total / (pass_s * 1e3)
                               if total > 0 else None),
            our_kernels_ms=ours,
            our_kernels_share_of_busy=(sum(ours.values()) / total
                                       if total > 0 else None),
            device_ops_launched=n_kernels, top_ops=rows[:12])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import numpy as np

    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.ops import build
    from mitsuba3_plt_tpu_torch.scene.presets import (cornell_box,
                                                      grating_scene,
                                                      mesh_scene)
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    ph = Phase("card")
    ph.emit(nvidia_smi=smi, device=kind, torch=torch.__version__,
            cuda=torch.version.cuda, count=torch.cuda.device_count())

    ph = Phase("build")
    build.load_library()
    registers, spills = ptxas_report(build.build_log)
    ph.emit(sources=list(build.SOURCES), registers=registers, spills=spills)

    ph = Phase("mesh82k-scene")
    mscene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, device="cuda")
    ct = mscene.ctab2
    ph.emit(faces=mscene.geo.n_faces, route=mscene.intersect_route(),
            supers=list(ct.supers.shape), boxes=list(ct.boxes.shape),
            rows=list(ct.rows.shape))
    require(mscene.intersect_route() == "clu2", "mesh82k must route to clu2")
    ph = Phase("mesh82k-packet-scene")
    pscene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, accel="packet",
                        device="cuda")
    ph.emit(faces=pscene.geo.n_faces, route=pscene.intersect_route(),
            nodes=list(pscene.pbvh.nodes.shape),
            tri=list(pscene.pbvh.tri.shape))
    require(pscene.intersect_route() == "packet",
            "mesh82k with packet tables must route to packet")

    ph = Phase("cbox-scene")
    cscene = cornell_box(CBOX_W, CBOX_H, device="cuda")
    em = cscene.emitters
    ph.emit(faces=cscene.geo.n_faces, route=cscene.intersect_route(),
            tri_isect=list(cscene.geo.tri_isect.shape),
            emitter_types=list(em.present_types),
            tri_idx=em.tri_idx.tolist(), tri_cdf=em.tri_cdf.tolist(),
            area=em.area.tolist())
    require(cscene.geo.n_faces == 36 and cscene.intersect_route() == "brute"
            and em.tri_idx.tolist() == [[34, 35]],
            "the Cornell box must have 36 faces, the brute route and a "
            "two-triangle light")
    ph = Phase("isect-sets")
    tscene = mesh_scene(CBOX_W, CBOX_H, TOOL_SUBDIV, device="cuda")
    csets = {**bi.ray_sets(cscene, TOOL_LANES, 0),
             **bi.cbox_ray_sets(cscene, TOOL_LANES // (CBOX_W * CBOX_H), 0)}
    tsets = bi.ray_sets(tscene, TOOL_LANES, 0)
    spp = TOOL_LANES // (CBOX_W * CBOX_H)
    mask_scenes = [(label, sc, ms.tables(sc), ms.ray_sets(sc, spp, 0))
                   for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    sweep_scenes = [(label, sc, us.sweep_rays(sc, TOOL_LANES, 0))
                    for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    macc_scenes = [(label, sc, us.sweep_rays(sc, MACC_LANES, 0))
                   for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    ph.emit(cbox_sets=list(csets), mesh_faces=tscene.geo.n_faces,
            mesh_sets=list(tsets), lanes=TOOL_LANES,
            mask_sets=list(mask_scenes[0][3]),
            clusters={label: {k: t.boxes.shape[0] for k, t in tabs.items()}
                      for label, _, tabs, _ in mask_scenes})

    ph = Phase("kernels")
    n = MAIN_W * MAIN_H * MAIN_SPP_PASS
    rng = np.random.default_rng(0)
    iscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    rows = check_intersect(iscene, n, rng)
    rows.append(check_sample(n, rng, "cuda"))
    rows.append(check_lobe_sum(n, rng, "cuda"))
    clu2_rows, ray_sets, clu2_ms = check_clu2(mscene, rng)
    rows += clu2_rows + check_bvh(pscene, ray_sets, clu2_ms, rng)
    del ray_sets
    for r in rows:
        emit({"phase": "kernels", **r})
    pick = {k: csets[k] for k in ("coherent", "incoherent")}
    brute = check_brute("cbox", cscene, pick)
    check_brute("mesh5k", tscene, tsets, PLAIN_LANES)
    rows += brute["incoherent"]
    _, _, ttabs, tmask = mask_scenes[1]
    clu = check_clu("mesh5k", ttabs,
                    {k: tmask[k] for k in ("incoherent", "depth0",
                                           "shadow0")}, PLAIN_LANES)
    rows += [clu["incoherent"], clu["shadow0"]]
    check_sweep("cbox", cscene, sweep_scenes[0][2])
    sweep = check_sweep("mesh5k", tscene, sweep_scenes[1][2], PLAIN_LANES)
    rows += [sweep["closest", 16, False], sweep["any hit", 16, False]]
    check_macc("cbox", cscene, macc_scenes[0][2])
    macc = check_macc("mesh5k", tscene, macc_scenes[1][2], PLAIN_LANES)
    rows += [macc[8], check_fma(rng, "cuda")]
    ph.emit(checked=[r["name"] for r in rows])
    tool_launches = isect_tool([("cbox", cscene, csets),
                                ("mesh5k", tscene, tsets)])
    del csets, tsets
    mask_launches = mask_sort_tool(mask_scenes)
    sweep_launches = unroll_sweep_tool(sweep_scenes)
    macc_launches = q_multiacc_tool(macc_scenes)
    mfu_launches, roofs = kernel_mfu_tool(macc_scenes, "cuda")
    # the tools' rays and tables (~0.5 GB) must not count in the main
    # paths' peak memory
    del mask_scenes, sweep_scenes, macc_scenes, ttabs, tmask

    golden_ztest("golden", grating_scene(24, 24, coherence=1e3,
                                         device="cuda"),
                 PLTIntegrator(max_depth=3, rr_depth=9), "grating_plt.npz", 12)
    golden_ztest("golden-mesh20k", mesh_scene(32, 32, 5, device="cuda"),
                 PathIntegrator(max_depth=3, rr_depth=9), "mesh20k_path.npz",
                 8)
    golden_ztest("golden-mesh20k-packet",
                 mesh_scene(32, 32, 5, accel="packet", device="cuda"),
                 PathIntegrator(max_depth=3, rr_depth=9), "mesh20k_path.npz",
                 8)
    golden_ztest("golden-cbox", cornell_box(32, 32, device="cuda"),
                 PathIntegrator(max_depth=4, rr_depth=9), "cbox_path.npz", 16)

    gscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    ginteg = PLTIntegrator(max_depth=MAIN_DEPTH, rr_depth=MAIN_RR)
    g_res, _ = main_path("main", gscene, ginteg, MAIN_SPP_PASS,
                         GRATING_LAUNCHES)
    split("split", gscene, ginteg, sum(g_res["pass_s"]) / TIMED_PASSES,
          MAIN_SPP_PASS, "chip_smoke_profile.json")

    minteg = PathIntegrator(max_depth=MESH_DEPTH, rr_depth=MESH_RR)
    m_res, _ = main_path("main-mesh82k", mscene, minteg, MESH_SPP_PASS,
                         MESH_LAUNCHES)
    split("split-mesh82k", mscene, minteg,
          sum(m_res["pass_s"]) / TIMED_PASSES, MESH_SPP_PASS,
          "chip_smoke_profile_mesh82k.json")

    p_res, p_img = main_path("main-mesh82k-packet", pscene, minteg,
                             MESH_SPP_PASS, PACKET_LAUNCHES, **REGEN)
    same_image("main-mesh82k-packet", p_img, pscene, minteg, MESH_SPP_PASS)
    split("split-mesh82k-packet", pscene, minteg,
          sum(p_res["pass_s"]) / TIMED_PASSES, MESH_SPP_PASS,
          "chip_smoke_profile_mesh82k_packet.json", **REGEN)
    _, r_img = main_path("main-mesh82k-regen", mscene, minteg, MESH_SPP_PASS,
                         REGEN_CLU2_LAUNCHES, **REGEN)
    same_image("main-mesh82k-regen", r_img, mscene, minteg, MESH_SPP_PASS)

    cinteg = PathIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR)
    c_res, _ = main_path("main-cbox", cscene, cinteg, CBOX_SPP_PASS,
                         CBOX_LAUNCHES)
    split("split-cbox", cscene, cinteg, sum(c_res["pass_s"]) / TIMED_PASSES,
          CBOX_SPP_PASS, "chip_smoke_profile_cbox.json")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "measured_bound_ms",
            "measured_bound_by", "library_ms")
    kernels = []
    for r in rows:
        own = (p_res["launches"] if PACKET_LAUNCHES[r["name"]]
               else m_res["launches"] if MESH_LAUNCHES[r["name"]]
               else tool_launches if r["name"] in TOOL_KERNELS
               else mask_launches if r["name"] in MASK_KERNELS
               else sweep_launches if r["name"] in SWEEP_KERNELS
               else macc_launches if r["name"] in MACC_KERNELS
               else mfu_launches if r["name"] in MFU_KERNELS
               else g_res["launches"])
        r = dict(r, launches=own[r["name"]], **measured_bound(r, roofs))
        kernels.append({k: r[k] for k in keys})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
