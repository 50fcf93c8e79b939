"""The table gradient of `core.math.take_rows` two ways, on the gradient
paths that gather material and emitter rows, and on a sweep of table
sizes.

`take_rows(table, idx)` sums each row's lanes of the cotangent g [N, C]
into the table's gradient [R, C], by one of two functions of
`core.math`:

  one_hot    `rows_sum_one_hot`: one_hot(idx)^T @ g, the [N, R] one-hot
             built in g's dtype, one matrix product;
  index_add  `rows_sum_index_add`: zeros(R, C).index_add_(0, idx, g), one
             atomic add a lane and column.

`take_rows` uses the first up to `ONE_HOT_MAX_ROWS` rows. Each cell is a
gradient evaluation of `ad.render_loss_grad`. `run` times it end to end
(wall ms, each evaluation ending in a device sync) under each way in the
order A B B A, and in one more evaluation times both ways on every
backward call's own (idx, g) with the timer, checking that they agree.
`sweep` times both ways on seeded uniform rows of tables of R rows. The
module has no timing loop of its own: `run` and `sweep` take a timer (a
function of a callable that returns its device ms) or report no times.

On the CPU (no times):

    from mitsuba3_plt_tpu_torch.tools import take_rows_ab as tr
    for row in tr.run(tr.cells(16, 12, 16, 16, device="cpu"), evals=1):
        print(row)
    print(tr.sweep((2, 300), 4000, 3, device="cpu"))

On the card, at the sizes of chip_smoke.py's gradient phases:

    python -m mitsuba3_plt_tpu_torch.tools.take_rows_ab
"""
from __future__ import annotations

import contextlib
import json
import time

import torch

from ..core import math as m

WAYS = ("one_hot", "index_add")
GRAD = {"one_hot": m.rows_sum_one_hot, "index_add": m.rows_sum_index_add}
# the sweep's table sizes, at the grating gradient's lanes a pass
SWEEP_ROWS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
SWEEP_LANES = 480_000


@contextlib.contextmanager
def backward_as(fn):
    """`take_rows`'s backward computes the table gradient by
    fn(flat idx [N], flat g [N, C], rows) while the context is open."""
    saved = m._TakeRows.__dict__["backward"]

    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat_idx = idx.reshape(-1)
        flat = g.reshape(flat_idx.shape[0], -1)
        gt = fn(flat_idx, flat, ctx.n_rows)
        return gt.reshape((ctx.n_rows,) + g.shape[idx.dim():]), None

    m._TakeRows.backward = staticmethod(
        torch.autograd.function.once_differentiable(backward))
    try:
        yield
    finally:
        m._TakeRows.backward = saved


def cells(grating_w=800, grating_h=600, cbox_w=512, cbox_h=512, depth=7,
          rr=50, spp=4, mesh_subdiv=3, device="cuda"):
    """{name: evaluate}: chip_smoke.py's gradient phases, each one
    gradient evaluation of the mean image (grad-grating: PLT on the four
    grating parameters; grad-cbox-path / -prb: the path tracer's and PRB's
    base_color gradient), all on tables of a few rows, and grad-mesh-attr,
    the path tracer's gradient of the shading rows `geo.tri_attr` of the
    mesh scene's icosphere (1,280 rows at subdiv 3) at the cbox's size,
    a table on the other side of ONE_HOT_MAX_ROWS."""
    from .. import ad
    from ..integrators.path import PathIntegrator
    from ..integrators.plt import PLTIntegrator
    from ..integrators.prb import PRBIntegrator
    from ..scene.presets import cornell_box, grating_scene, mesh_scene

    gscene = grating_scene(grating_w, grating_h, device=device)
    cscene = cornell_box(cbox_w, cbox_h, device=device)
    mscene = mesh_scene(cbox_w, cbox_h, subdiv=mesh_subdiv, device=device)
    plt = PLTIntegrator(max_depth=depth, rr_depth=rr)
    path = PathIntegrator(max_depth=depth, rr_depth=rr)
    prb = PRBIntegrator(max_depth=depth, rr_depth=rr)
    gkeys = ["materials.grt_inv_period", "materials.grt_height",
             "materials.grt_multiplier", "materials.grt_coherence"]

    def grad(scene, integ, keys):
        return lambda: ad.render_loss_grad(scene, integ.sample, torch.mean,
                                           keys, seed=0, spp=spp)

    return {"grad-grating": grad(gscene, plt, gkeys),
            "grad-cbox-path": grad(cscene, path, ["materials.base_color"]),
            "grad-cbox-prb": grad(cscene, prb, ["materials.base_color"]),
            "grad-mesh-attr": grad(mscene, path, ["geo.tri_attr"])}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _wall_ms(evaluate):
    t0 = time.perf_counter()
    out = evaluate()
    _sync()
    return (time.perf_counter() - t0) * 1e3, out


def per_call(evaluate, timer=None):
    """One evaluation whose every table-gradient call is computed both
    ways on the same (idx, g): the calls by (rows, lanes, columns), with
    each way's summed ms (timer) and the largest difference of the two
    gradients over the largest entry."""
    calls = {}

    def both(idx, g, n_rows):
        out = {w: GRAD[w](idx, g, n_rows) for w in WAYS}
        key = (n_rows, idx.shape[0], g.shape[1])
        c = calls.setdefault(key, {"calls": 0, "rel_diff": 0.0,
                                   **{f"{w}_ms": 0.0 for w in WAYS}})
        c["calls"] += 1
        scale = max(out["one_hot"].abs().max().item(), 1e-30)
        c["rel_diff"] = max(c["rel_diff"], (out["one_hot"] - out[
            "index_add"]).abs().max().item() / scale)
        if timer is not None:
            for w in WAYS:
                c[f"{w}_ms"] += timer(lambda: GRAD[w](idx, g, n_rows))
        return out["index_add"]

    with backward_as(both):
        evaluate()
    return [{"rows": r, "lanes": n, "columns": k, **v}
            for (r, n, k), v in sorted(calls.items())]


def run(cell_fns, evals=3, timer=None):
    """One row a cell: its gradient's wall ms under each way (a warm-up,
    then evals evaluations each in the order one_hot, index_add,
    index_add, one_hot), the gradients' largest difference over their
    largest entry, and `per_call`'s rows."""
    rows = []
    for name, evaluate in cell_fns.items():
        ms = {w: [] for w in WAYS}
        grads = {}
        for w in WAYS:
            with backward_as(GRAD[w]):
                grads[w] = evaluate()[1]
        for _ in range(evals):
            for w in WAYS + WAYS[::-1]:
                with backward_as(GRAD[w]):
                    ms[w].append(_wall_ms(evaluate)[0])
        diff = max((grads["one_hot"][k] - grads["index_add"][k]).abs().max()
                   .item() / max(grads["one_hot"][k].abs().max().item(),
                                 1e-30) for k in grads["one_hot"])
        rows.append({"cell": name, "wall_ms": ms,
                     "median_ms": {w: sorted(v)[len(v) // 2]
                                   for w, v in ms.items()},
                     "grad_rel_diff": diff,
                     "calls": per_call(evaluate, timer)})
    return rows


def sweep(rows=SWEEP_ROWS, lanes=SWEEP_LANES, columns=(1, 3), timer=None,
          device="cuda", seed=0):
    """One row for each (R, C): both ways on the same g [lanes, C] and
    idx uniform over R rows (numpy, seeded): each way's ms (timer), the
    one-hot's bytes and the largest difference over the largest entry."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for c in columns:
        g = torch.as_tensor(rng.normal(size=(lanes, c)).astype(np.float32),
                            device=device)
        for r in rows:
            idx = torch.as_tensor(rng.integers(0, r, lanes), device=device)
            got = {w: GRAD[w](idx, g, r) for w in WAYS}
            row = {"rows": r, "lanes": lanes, "columns": c,
                   "one_hot_bytes": lanes * r * 4,
                   "rel_diff": (got["one_hot"] - got["index_add"]).abs()
                   .max().item() / got["index_add"].abs().max().item()}
            if timer is not None:
                for w in WAYS:
                    row[f"{w}_ms"] = timer(lambda: GRAD[w](idx, g, r))
            out.append(row)
            del got
    return out


def event_timer(fn, reps=20):
    """Device ms of one fn() by CUDA events: a warm-up, then the mean of
    reps calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import subprocess

    if not torch.cuda.is_available():
        raise SystemExit("take_rows_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    for row in run(cells(), timer=event_timer):
        print(json.dumps(row))
    for row in sweep(timer=event_timer):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
