"""The q brute force's unroll sweep: the unroll-depth variants of the
closest hit (B11a, one of them with two accumulators) and of the any hit
(B11b) against B1/B2 on the same rays.

Port of `tools/experiments/isect_unroll_sweep.py`'s `__main__`: 2^20 rays
with origins uniform in the middle 90% of the scene box and uniform
directions; the closest hit with maxt = inf at unroll 8, 16 and 32, and
16 with two accumulators; the any hit at unroll 8, 16 and 32 with maxt
0.99 of B1's t where B1 hits and 2.0 elsewhere. On this card "unroll" is
the depth of `#pragma unroll` of a thread's row loop
(`ops/csrc/intersect_sweep.cu`). The module has no timing loop: `run`
takes a timer (a function of a callable that returns its device ms) or
reports no times.

On the CPU (plain versions; ms are None):

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
    scene = cornell_box(16, 16, device="cpu")
    for row in us.run(scene, us.sweep_rays(scene, 4096)):
        print(row)
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import intersect as isect
from . import bench_isect as bi

CLOSEST = ((8, False), (16, False), (32, False), (16, True))  # (unroll, dual)
ANYHIT = (8, 16, 32)
N_RAYS = 1 << 20


def sweep_rays(scene, n=N_RAYS, seed=0):
    """(o, d, maxt) of n rays: origins uniform in [5%, 95%] of the scene
    box on each axis, directions uniform on the sphere, maxt = inf."""
    rng = np.random.default_rng(seed)
    p0, e1, e2 = bi._soup(scene)
    p = np.concatenate([p0, p0 + e1, p0 + e2])
    lo, hi = p.min(0), p.max(0)
    o = lo + rng.random((n, 3)) * (hi - lo) * 0.9 + 0.05 * (hi - lo)
    d = bi._unit(rng.normal(size=(n, 3)))
    return bi._tensors(scene, o, d, np.full(n, np.inf))


def run(scene, rays, timer=None):
    """One row per variant: closest hit (CLOSEST) with the share of lanes
    whose prim equals intersect_q's, any hit (ANYHIT) with the share whose
    flag equals occluded_q's on the any-hit maxt, the rows the variant
    runs and, with a timer, ms and ms per million rays. The references
    themselves come first in each kind, with unroll None."""
    geo, F = scene.geo, scene.geo.n_faces
    o, d, mt = rays
    n = o.shape[0]
    q = (geo.tri_q, geo.tri_anchor)

    def row(kind, unroll, dual, fn, **agree):
        ms = timer(fn) if timer is not None else None
        rows_run = (F if unroll is None
                    else isect.q_variant_rows(geo.tri_q.shape[0], F, unroll))
        return {"kind": kind, "unroll": unroll, "dual": dual, "n": n,
                "faces": F, "rows": rows_run, **agree, "ms": ms,
                "ms_per_mrays": None if ms is None else ms / (n / 1e6)}

    ref_t, ref_p, _, _ = isect.intersect_q(*q, o, d, mt, F)
    out = [row("closest", None, False,
               lambda: isect.intersect_q(*q, o, d, mt, F), prim_agree=1.0)]
    for unroll, dual in CLOSEST:
        def fn(u=unroll, du=dual):
            return isect.intersect_q_variant(*q, o, d, mt, F, u, du)
        out.append(row("closest", unroll, dual, fn,
                       prim_agree=bi._share(fn()[1] == ref_p)))
    msh = torch.where(torch.isfinite(ref_t), ref_t * 0.99, 2.0)
    ref_occ = isect.occluded_q(*q, o, d, msh, F)
    out.append(row("any hit", None, False,
                   lambda: isect.occluded_q(*q, o, d, msh, F),
                   occ_agree=1.0, occluded_share=bi._share(ref_occ)))
    for unroll in ANYHIT:
        def fn(u=unroll):
            return isect.occluded_q_variant(*q, o, d, msh, F, u)
        out.append(row("any hit", unroll, False, fn,
                       occ_agree=bi._share(fn() == ref_occ)))
    return out
