"""Per-kernel share of the card's roofs, against roofs measured on the card.

Port of `tools/experiments/kernel_mfu.py`, one function a probe, each
returning a row with the JAX tool's counts:

  fma_roof_probe   the FP32 FMA roof (B11d, `ops/mfu.py::fma_roof`) at
                   8,192 x 128 elements, timed chained (each output feeds
                   the next call): rows 128 FMA_ITERS 2 FLOP, FMA only; with
                   the kernel's SASS count (`ops/mfu.py::fma_roof_sass`)
                   also the instructions it issues a second, the slot roof;
  hbm_probe        a roll times a scale over 512 MB, timed chained; in eager
                   PyTorch the roll and the product are two kernels, so the
                   bytes counted are four passes over the buffer (XLA fuses
                   the two into one read and one write: the JAX tool's two);
                   beside it a plain copy of the buffer (one read, one
                   write), since PyTorch's roll kernel need not stream at
                   the card's rate;
  q_probe          B1 and B2 on 2^21 rays (maxt inf), N T_pad pairs with
                   T_pad the face count rounded up to the TPU kernels'
                   unroll (16 closest, 32 any hit), 38 FLOP and 32 / 28
                   issue slots a pair (the JAX tool's analytic counts);
  clu2_probe       B5 on the 2^20 pixel-centre camera rays of
                   mesh_scene(1024, 1024, 6), with the host walk of the
                   scene's skip-link BVH over 512 sampled rays (nodes
                   visited and triangles tested a ray; 14 FLOP a node and 38
                   a triangle, the useful work);
  lobe_sum_probe   B4 at half 3, separable, 3 channels, on 2^20 lanes with
                   the JAX tool's inputs.

`shares` states a row against both roofs: the measured ones (`roofs`:
the highest FMA and slot rates of the `fma_roof_probe` rows given, the
higher of `hbm_probe`'s two bandwidths) and the published ones (67 TFLOP/s FP32 and 3.35 TB/s; a slot a clock is 67 / 2
T slots/s). The JAX tool's `main` divided by a datasheet rate and never
called its two probes, which mis-timed through its TPU backend; this port
calls both.

The module has no timing loop: a probe takes `timer` (a function of a
callable that returns its device ms) and `chained` (a function of a step
x -> x and a first x that returns the device ms of one step, each call fed
the last one's output), or reports no times. On the CPU (plain versions,
no times):

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km
    scene = cornell_box(16, 16, device="cpu")
    print(km.fma_roof_probe("cpu", rows=8))
    print(km.q_probe(scene, us.sweep_rays(scene, 4096)))
    print(km.clu2_probe(*km.clu2_setup("cpu", 32, 5), samples=64))
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import grating as gops
from ..ops import intersect as isect
from ..ops import mfu
from ..scene.presets import mesh_scene_with_bvh

PUBLISHED_FLOPS = 67e12      # H100 SXM FP32 outside the tensor cores
PUBLISHED_BYTES = 3.35e12    # H100 SXM HBM3
FMA_ROWS = 1 << 13
HBM_FLOATS = 1 << 27         # 512 MB
HBM_PASSES = 4               # roll: read + write; product: read + write
Q_UNROLL, Q_UNROLL_A = 16, 32  # the TPU q kernels' unroll (T_pad)
Q_FLOP = 38                  # a (ray, triangle) pair, FMAs counted as 2
Q_SLOTS = {"closest": 32, "any hit": 28}
CLU2_RES, CLU2_SUBDIV = 1024, 6
NODE_FLOP, TRI_FLOP = 14, 38  # useful work of a node and a triangle test
WALK_SAMPLES, WALK_SEED = 512, 0
LOBE_LANES, LOBE_HALF, LOBE_SEED = 1 << 20, 3, 0
ANYHIT_ROWS, ANYHIT_RAYS = 256, 1 << 17  # anyhit_tests' block


def fma_roof_probe(device, chained=None, sass=None, rows=FMA_ROWS):
    """B11d over ones [rows, 128] with a = 0.9999999: FLOP (FMA only),
    with `chained` ms and FLOP/s, with `sass` (`mfu.count_sass`'s dict)
    the slots issued and slots/s."""
    x = torch.ones((rows, mfu.LANES), dtype=torch.float32, device=device)
    a = torch.full((mfu.SUB, mfu.LANES), 0.9999999, dtype=torch.float32,
                   device=device)
    out = mfu.fma_roof(x, a)
    n = rows * mfu.LANES
    row = {"probe": "fma roof", "rows": rows, "elements": n,
           "flop": n * mfu.FMA_ITERS * 2,
           "finite": bool(torch.isfinite(out).all())}
    if sass is not None:
        row.update(slots=n * sass["slots"], sass=sass)
    ms = chained(lambda v: mfu.fma_roof(v, a), x) if chained else None
    return _rates(row, ms)


def hbm_probe(device, chained=None, timer=None, n=HBM_FLOATS):
    """torch.roll(x, 1) * a over n float32, chained: the bytes of
    HBM_PASSES passes and, with `chained`, bytes/s; with `timer` also a
    copy of x into a second buffer (two passes) and its bytes/s."""
    x = torch.arange(n, dtype=torch.float32, device=device)
    a = torch.tensor(1.0000001, dtype=torch.float32, device=device)

    def step(v):
        return torch.roll(v, 1) * a

    dst = torch.empty_like(x)
    ok = bool(torch.equal(step(x)[1:], x[:-1] * a)
              and torch.equal(dst.copy_(x), x))
    row = {"probe": "hbm", "floats": n, "bytes": n * 4 * HBM_PASSES,
           "bytes_jax_count": n * 4 * 2, "copy_bytes": n * 4 * 2,
           "correct": ok}
    if timer is not None:
        row["copy_ms"] = timer(lambda: dst.copy_(x))
        row["copy_bytes_per_s"] = row["copy_bytes"] / (row["copy_ms"] * 1e-3)
    ms = chained(step, x) if chained else None
    return _rates(row, ms)


def q_probe(scene, rays, timer=None):
    """B1 and B2 on `rays` (o, d, maxt): a row each with the JAX tool's
    pairs, FLOP and slots, the pairs the any hit tests up to each ray's
    first hit (its loop leaves there), the hit or occluded share and, with
    a timer, ms and the rates."""
    geo, T = scene.geo, scene.geo.n_faces
    o, d, mt = rays
    n = o.shape[0]
    q = (geo.tri_q, geo.tri_anchor, o, d, mt, T)
    rows = []
    for kind, unroll in (("closest", Q_UNROLL), ("any hit", Q_UNROLL_A)):
        if kind == "closest":
            def fn():
                return isect.intersect_q(*q)
            share = {"hit_share": (fn()[1] >= 0).double().mean().item()}
        else:
            def fn():
                return isect.occluded_q(*q)
            share = {"occluded_share": fn().double().mean().item(),
                     "pairs_tested": anyhit_tests(geo.tri_q, geo.tri_anchor,
                                                  o, d, mt, T)}
        pairs = n * (-(-T // unroll) * unroll)
        row = {"probe": f"q {kind}", "n": n, "faces": T, "pairs": pairs,
               "flop": pairs * Q_FLOP, "slots": pairs * Q_SLOTS[kind],
               **share}
        ms = timer(fn) if timer is not None else None
        if ms is not None:
            row["gpairs_per_s"] = pairs / ms / 1e6
        rows.append(_rates(row, ms))
    return rows


def anyhit_tests(tri_q, anchor, o, d, mt, rows):
    """The triangle tests of an any-hit brute force that stops at each
    ray's first hit (all `rows` where it has none), summed over the rays:
    the rows tested ANYHIT_ROWS at a time as one [rays, ANYHIT_ROWS] block,
    ANYHIT_RAYS rays at a time."""
    total = 0
    for r0 in range(0, o.shape[0], ANYHIT_RAYS):
        r1 = r0 + ANYHIT_RAYS
        (o3, d3, c, m) = isect._ray_terms(anchor, o[r0:r1], d[r0:r1],
                                          mt[r0:r1])
        split = lambda x: tuple(v[:, None] for v in x)  # noqa: E731
        o3, d3, c = split(o3), split(d3), split(c)
        first = torch.full(m.shape, rows, dtype=torch.int64,
                           device=m.device)
        # from the last chunk to the first, so the earliest hit stays
        for s0 in reversed(range(0, rows, ANYHIT_ROWS)):
            qt = tri_q[s0: min(rows, s0 + ANYHIT_ROWS)].T.unsqueeze(1)
            ad, _, _, ts, inside = isect._q_terms(qt, o3, d3, c)
            hit = inside & (ts < m[:, None] * ad)
            first = torch.where(hit.any(1),
                                s0 + hit.to(torch.int8).argmax(1) + 1, first)
        total += int(first.sum())
    return total


def pixel_rays(scene):
    """(o, d, maxt) of one ray through each pixel centre, in scanline
    order (the JAX tool's sensor.sample_ray of (x + 0.5) / W)."""
    W, H = scene.sensor.resolution
    lane = torch.arange(W * H, device=scene.device)
    uv = torch.stack([(lane % W + 0.5) / W, (lane // W + 0.5) / H],
                     -1).to(torch.float32)
    o, d = scene.sensor.sample_ray(uv)
    return o, d, torch.full((W * H,), float("inf"), device=scene.device)


def bvh_walk_stats(bvh, o, d):
    """(nodes visited, triangles tested) summed over the rays o, d [n, 3]
    (numpy float32) of a host walk of the skip-link BVH that enters every
    box the ray meets in front of its origin, hit or no hit: the JAX
    tool's per-ray loop (`kernel_mfu.py:229-255`), all rays at once."""
    lo, hi = bvh.node_lo, bvh.node_hi
    cnt, miss = bvh.node_count, bvh.node_miss
    inv = 1.0 / np.where(np.abs(d) > 1e-12, d, np.float32(1e-12))
    node = np.zeros(len(o), np.int64)
    nodes_v = tris_t = 0
    live = node < len(lo)
    while live.any():
        k = node[live]
        t0 = (lo[k] - o[live]) * inv[live]
        t1 = (hi[k] - o[live]) * inv[live]
        near = np.minimum(t0, t1).max(-1)
        far = np.maximum(t0, t1).min(-1)
        nodes_v += len(k)
        enter = (near <= far) & (far > 0)
        leaf = enter & (cnt[k] > 0)
        tris_t += int(cnt[k][leaf].sum())
        node[live] = np.where(enter & ~leaf, k + 1, miss[k])
        live = (node >= 0) & (node < len(lo))
    return nodes_v, tris_t


def clu2_setup(device, res=CLU2_RES, subdiv=CLU2_SUBDIV):
    """(mesh_scene(res, res, subdiv) on `device`, the native builder's
    skip-link BVH of its icosphere, the one its treelet table was packed
    from) for `clu2_probe`."""
    return mesh_scene_with_bvh(res, res, subdiv, device=device)


def clu2_probe(scene, bvh, timer=None, samples=WALK_SAMPLES):
    """B5 on the pixel-centre camera rays of the mesh scene with the host
    walk's statistics over `samples` of them (`bvh` is its mesh's BVH):
    nodes and triangles a ray and the useful FLOP they need."""
    o, d, mt = pixel_rays(scene)
    n = o.shape[0]

    def fn():
        return isect.intersect_clu2(scene.ctab2, o, d, mt)

    hit = (fn()[1] >= 0).double().mean().item()
    sel = np.random.default_rng(WALK_SEED).integers(0, n, samples)
    nv, tt = bvh_walk_stats(bvh, o.cpu().numpy()[sel], d.cpu().numpy()[sel])
    per_ray = (nv * NODE_FLOP + tt * TRI_FLOP) / samples
    row = {"probe": "clu2", "n": n, "faces": scene.geo.n_faces,
           "hit_share": hit, "nodes_per_ray": nv / samples,
           "tris_per_ray": tt / samples, "useful_flop_per_ray": per_ray,
           "flop": n * per_ray}
    return _rates(row, timer(fn) if timer is not None else None)


def lobe_inputs(n, device):
    """The JAX tool's lobe-sum inputs: one wi, wo pair, wavelengths uniform
    in [400, 680) nm, grating (1, 0), inverse period (0.5, 0.5), q 0.1,
    3 lobes, profile 0, multiplier 1, coherence 6e5, cone 1e-7."""
    rng = np.random.default_rng(LOBE_SEED)
    f32 = np.float32
    ins = dict(
        wi=np.tile(np.array([[0.3, 0.1, 0.946]], f32), (n, 1)),
        wo=np.tile(np.array([[-0.25, 0.2, 0.947]], f32), (n, 1)),
        wl_nm=rng.uniform(400, 680, (n, 3)).astype(f32),
        grating_dir=np.tile(np.array([[1.0, 0.0]], f32), (n, 1)),
        inv_period=np.tile(np.array([[0.5, 0.5]], f32), (n, 1)),
        q=np.full(n, 0.1, f32), lobes=np.full(n, 3, np.int32),
        gtype=np.zeros(n, np.int32), multiplier=np.ones(n, f32),
        coherence=np.full(n, 6e5, f32), a_cone=np.full(n, 1e-7, f32))
    return {k: torch.as_tensor(v, device=device) for k, v in ins.items()}


def lobe_sum_probe(device, timer=None, n=LOBE_LANES):
    """B4 at half LOBE_HALF, separable, 3 channels on the JAX tool's
    inputs: with a timer ms and ms per million lanes (the JAX tool counts
    no operations here)."""
    ins = lobe_inputs(n, device)

    def fn():
        return gops.grating_lobe_sum(**ins, half=LOBE_HALF, separable=True,
                                     n_channels=3)

    row = {"probe": "lobe sum", "n": n, "half": LOBE_HALF,
           "finite": bool(torch.isfinite(fn()).all())}
    return _rates(row, timer(fn) if timer is not None else None)


def _rates(row, ms):
    row["ms"] = ms
    if ms is None:
        return row
    sec = ms * 1e-3
    if "n" in row:  # per million rays or lanes
        row["ms_per_m"] = ms / (row["n"] / 1e6)
    for key in ("flop", "slots", "bytes"):
        if key in row:
            row[key + "_per_s"] = row[key] / sec
    return row


def roofs(fma_rows, hbm_row):
    """The measured roofs beside the published ones: the highest FLOP/s
    (FMA only) and slots/s (the instructions the probe issues, from its
    SASS) of the timed `fma_roof_probe` rows, the higher of the HBM
    probe's roll and copy bytes/s."""
    return {"flops": max(r["flop_per_s"] for r in fma_rows),
            "slots": max(r["slots_per_s"] for r in fma_rows),
            "bytes": max(hbm_row["bytes_per_s"],
                         hbm_row.get("copy_bytes_per_s", 0.0)),
            "published_flops": PUBLISHED_FLOPS,
            "published_slots": PUBLISHED_FLOPS / 2,
            "published_bytes": PUBLISHED_BYTES}


def shares(row, r):
    """A timed row's rates as shares of the roofs `r` (`roofs`): FLOP/s of
    the measured FMA roof and of the published FLOP/s; slots/s of the
    measured slot roof, of the JAX tool's rule (the measured FMA roof / 2)
    and of the published rate / 2; bytes/s of the measured and the
    published bandwidth."""
    out = dict(row)
    if "flop_per_s" in row:
        out["flop_share"] = {
            "measured": row["flop_per_s"] / r["flops"],
            "published": row["flop_per_s"] / r["published_flops"]}
    if "slots_per_s" in row:
        out["slot_share"] = {
            "measured": row["slots_per_s"] / r["slots"],
            "jax_rule": row["slots_per_s"] / (r["flops"] / 2),
            "published": row["slots_per_s"] / r["published_slots"]}
    if "bytes_per_s" in row:
        out["bytes_share"] = {
            "measured": row["bytes_per_s"] / r["bytes"],
            "published": row["bytes_per_s"] / r["published_bytes"]}
    return out
