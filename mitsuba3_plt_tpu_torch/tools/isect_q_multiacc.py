"""The multi-accumulator q closest hit (B11c) against B1 on the same rays.

Port of `tools/experiments/isect_q_multiacc.py`'s run: 2^21 rays with
origins in the middle 90% of the scene box and uniform directions, maxt
inf (`isect_unroll_sweep.sweep_rays`: the JAX tool draws its origins in
[-0.9, 0.9]^3 of cbox.xml's box, a file the repository does not hold, so
the port runs on the presets); B1 (`intersect_q`, one accumulator) first,
then `intersect_q_macc` at nacc 2, 4 and 8 with the share of lanes whose
prim equals B1's. The module has no timing loop: `run` takes a timer (a
function of a callable that returns its device ms) or reports no times.

On the CPU (plain versions; ms are None):

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import isect_q_multiacc as qm
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
    scene = cornell_box(16, 16, device="cpu")
    for row in qm.run(scene, us.sweep_rays(scene, 4096)):
        print(row)
"""
from __future__ import annotations

from ..ops import intersect as isect
from . import bench_isect as bi

NACCS = isect.Q_MACC_NACCS


def run(scene, rays, timer=None):
    """One row for B1 (nacc None), then one per nacc of NACCS: the rows
    run, the share of lanes whose prim equals B1's and the share that hit
    and, with a timer, ms and ms per million rays."""
    geo, F = scene.geo, scene.geo.n_faces
    o, d, mt = rays
    n = o.shape[0]
    q = (geo.tri_q, geo.tri_anchor)

    def row(nacc, fn, prim):
        ms = timer(fn) if timer is not None else None
        rows = (F if nacc is None else isect.q_variant_rows(
            geo.tri_q.shape[0], F, isect.Q_MACC_UNROLL))
        return {"nacc": nacc, "n": n, "faces": F, "rows": rows,
                "prim_agree": bi._share(prim == ref_p),
                "hit_share": bi._share(prim >= 0), "ms": ms,
                "ms_per_mrays": None if ms is None else ms / (n / 1e6)}

    ref_p = isect.intersect_q(*q, o, d, mt, F)[1]
    out = [row(None, lambda: isect.intersect_q(*q, o, d, mt, F), ref_p)]
    for nacc in NACCS:
        def fn(k=nacc):
            return isect.intersect_q_macc(*q, o, d, mt, F, k)
        out.append(row(nacc, fn, fn()[1]))
    return out
