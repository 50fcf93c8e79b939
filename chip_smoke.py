#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, ~80 s with the build

Phases, each printing one JSON line:
  1. card     name and power limit (nvidia-smi) and torch's device name;
  2. build    the CUDA kernels from ops/csrc, with nvcc's register report;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's lane count, with the tolerance stated, and
              both timed with CUDA events (10 back-to-back calls, median
              of 7 such runs);
  4. golden   grating_scene(24, 24, coherence=1e3), PLT depth 3 / rr 9,
              4 seeds x 12 spp, Sidak z-test against tests/golden/
              grating_plt.npz;
  5. main     grating_scene(800, 600), PLT depth 7 / rr 50, 4 spp per pass:
              one warm-up pass, then three timed passes; the image must be
              finite and non-zero and each kernel must launch 7 times per
              pass (once per bounce);
  6. split    device time of one pass by kernel (torch.profiler), written
              to chiprun_out/chip_smoke_profile.json.
Then the kernel list, the nvidia-smi line, and the final status line.
Every failure raises and exits non-zero.
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
TIMED_PASSES = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


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
    return ok.float().mean().item()


def kernel_registers(log: str) -> dict:
    """{kernel instance: registers per thread} from nvcc's -Xptxas -v
    report (entry names shortened to name<template args>)."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"(q_kernel|lobe_sum_kernel|sample_kernel)"
                          r"I((?:L[ib]\d+E)+)E", entry)
            if k:
                args = re.findall(r"L([ib])(\d+)E", k.group(2))
                entry = f"{k.group(1)}<{','.join(v for _, v in args)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


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
    b, by = bound_ms(nbytes(geo.tri_q, geo.tri_anchor, o, d, maxt, got),
                     n * (Q_RAY_SETUP_OPS + geo.n_faces * Q_TEST_OPS))
    closest = {"name": "intersect_q", "route": "cuda",
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1373",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": None,
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
    tested = torch.full((n,), geo.n_faces, dtype=torch.int64, device=dev)
    o3, d3, c, mt = isect._ray_terms(geo.tri_anchor, so, sd, smt)
    for ti in reversed(range(geo.n_faces)):
        ad, _, _, ts, inside = isect._q_terms(geo.tri_q[ti], o3, d3, c)
        tested = torch.where(inside & (ts < mt * ad), ti + 1, tested)
    ms_a = time_ms(lambda: isect.occluded_q(*sargs))
    plain_a = time_ms(lambda: isect.occluded_q_plain(*sargs))
    b_a, by_a = bound_ms(
        nbytes(geo.tri_q, geo.tri_anchor, so, sd, smt, occ),
        n * Q_RAY_SETUP_OPS + tested.sum().item() * Q_ANYHIT_TEST_OPS)
    anyhit = {"name": "occluded_q", "route": "cuda",
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
              "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1411",
              "max_abs_err": 1.0 - frac_occ, "ms": ms_a, "plain_ms": plain_a,
              "bound_ms": b_a, "bound_by": by_a, "library_ms": None,
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
            b, by = bound_ms(nbytes(ins, got), nn * lobe_sum_ops(half, sep, 3))
            row = {"name": "grating_lobe_sum", "route": "cuda",
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:230",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
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
            b, by = bound_ms(nbytes(ins, got), n * sample_ops(3, ndf))
            row = {"name": "grating_sample", "route": "cuda",
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:593",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None,
                   "n": n, "agreement": worst}
    return row


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def golden_ztest():
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    ref = np.load(os.path.join(HERE, "tests", "golden", "grating_plt.npz"))
    scene = grating_scene(24, 24, coherence=1e3, device="cuda")
    integ = PLTIntegrator(max_depth=3, rr_depth=9)
    imgs = np.stack([render(scene, integ, seed=s, spp=12).cpu().numpy()
                     for s in range(4)])
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    sigma = np.sqrt((var + ref["var"]) / 4 + 1e-8)
    z = np.abs(mean - ref["mean"]) / sigma
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    thresh = -torch.special.ndtri(
        torch.tensor(alpha / 2, dtype=torch.float64)).item()
    n_fail = int((z > thresh).sum())
    res = {"phase": "golden", "pixels": int(z.size), "fail": n_fail,
           "max_z": float(z.max()), "thresh": thresh,
           "mean": float(mean.mean()), "ref_mean": float(ref["mean"].mean())}
    emit(res)
    require(n_fail == 0, f"golden z-test: {n_fail} pixels fail")


def main_path(W, H):
    import torch

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    scene = grating_scene(W, H, device="cuda")
    integ = PLTIntegrator(max_depth=MAIN_DEPTH, rr_depth=MAIN_RR)
    warm = {}
    render(scene, integ, seed=0, spp=MAIN_SPP_PASS,
           spp_per_pass=MAIN_SPP_PASS, stats=warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    spp = MAIN_SPP_PASS * TIMED_PASSES
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    img = render(scene, integ, seed=1, spp=spp, spp_per_pass=MAIN_SPP_PASS,
                 stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    res = {"phase": "main", "width": W, "height": H, "max_depth": MAIN_DEPTH,
           "rr_depth": MAIN_RR, "spp": spp, "spp_per_pass": MAIN_SPP_PASS,
           "lanes_per_pass": stats["lanes_per_pass"],
           "warmup_pass_s": warm["pass_s"][0], "pass_s": stats["pass_s"],
           "wall_s": wall,
           "camera_samples_per_s": W * H * spp / wall,
           "ms_per_spp": wall * 1e3 / spp,
           "peak_mem_bytes": peak, "launches": launches,
           "image_mean": mean, "finite": finite}
    emit(res)
    require(finite and mean > 0, "main-path image not finite and non-zero")
    for name, count in launches.items():
        require(count == MAIN_DEPTH * TIMED_PASSES,
                f"{name} launched {count} times, expected "
                f"{MAIN_DEPTH * TIMED_PASSES}")
    return scene, integ, res


def split(scene, integ, pass_s):
    """Device time of one main-path pass by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba3_plt_tpu_torch.integrators.common import render

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(scene, integ, seed=2, spp=MAIN_SPP_PASS,
               spp_per_pass=MAIN_SPP_PASS)
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
    ours = {"q_kernel": 0.0, "lobe_sum_kernel": 0.0, "sample_kernel": 0.0}
    n_kernels = 0
    for r in rows:
        for key in ours:
            if key in r["name"]:
                ours[key] += r["device_ms"]
        n_kernels += r["count"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.json"), "w") as f:
        json.dump({"pass_wall_ms": pass_s * 1e3, "device_ms": total,
                   "ops": rows}, f, indent=1)
    res = {"phase": "split", "pass_wall_ms": pass_s * 1e3,
           "device_busy_ms": total,
           "device_idle_share": (1.0 - total / (pass_s * 1e3)
                                 if total > 0 else None),
           "our_kernels_ms": ours, "device_ops_launched": n_kernels,
           "top_ops": rows[:12]}
    emit(res)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import numpy as np

    from mitsuba3_plt_tpu_torch.ops import build
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "registers": kernel_registers(build.build_log)})

    n = MAIN_W * MAIN_H * MAIN_SPP_PASS
    rng = np.random.default_rng(0)
    iscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    rows = check_intersect(iscene, n, rng)
    rows.append(check_sample(n, rng, "cuda"))
    rows.append(check_lobe_sum(n, rng, "cuda"))
    for r in rows:
        emit({"phase": "kernels", **r})

    golden_ztest()
    scene, integ, main_res = main_path(MAIN_W, MAIN_H)
    split(scene, integ, sum(main_res["pass_s"]) / len(main_res["pass_s"]))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in rows:
        r = dict(r, launches=main_res["launches"][r["name"]])
        kernels.append({k: r[k] for k in keys})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
