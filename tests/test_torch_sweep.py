"""The unroll-sweep variants of the q brute force (B11a, B11b) against the
JAX package on the CPU: the closest hit against the JAX tool's own kernel
(`tools/experiments/isect_unroll_sweep.py::make_q_kernel` through its
`q_variant`, run in interpret mode), the any hit against
`pallas_occluded_q` in interpret mode with the tool's infinite-maxt rule,
and the sweep tool (`tools/isect_unroll_sweep.py`) on the CPU."""
import importlib.util
import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from mitsuba3_plt_tpu.ops.intersect_pallas import pallas_occluded_q
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

N_RAYS = 512
SWEEP_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "experiments",
    "isect_unroll_sweep.py")


@pytest.fixture(scope="module")
def sweep():
    """The JAX tool as a module (its `__main__` block does not run), its
    `pallas_call` run in interpret mode: `q_variant` asks for
    interpret=False, which needs a TPU."""
    spec = importlib.util.spec_from_file_location("jax_unroll_sweep",
                                                  SWEEP_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, **{**kw, "interpret": True})

    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                   pallas_call=pallas_call)
    return mod


@pytest.fixture(scope="module")
def cbox():
    return tpresets.cornell_box(16, 16, device="cpu")


def _table(name, cbox):
    """(tri_q [T_pad, 16], anchor [3], faces, rays (o, d)): the Cornell box
    with the sweep's rays, or 20 random triangles that each appear twice
    (every hit an exact tie between an even and an odd row) with rays
    through the middle of their box."""
    if name == "cbox":
        o, d, _ = us.sweep_rays(cbox, N_RAYS, seed=3)
        g = cbox.geo
        return g.tri_q.numpy(), g.tri_anchor.numpy(), g.n_faces, (
            o.numpy(), d.numpy())
    rng = np.random.default_rng(8)
    p0 = rng.uniform(-1, 1, (20, 3))
    p1 = p0 + rng.normal(scale=0.6, size=(20, 3))
    p2 = p0 + rng.normal(scale=0.6, size=(20, 3))
    p = [np.repeat(x, 2, axis=0) for x in (p0, p1, p2)]
    tri_q, anchor = tisect.pack_tri_q(*p)
    o = rng.uniform(-0.5, 0.5, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return tri_q, anchor, 40, (o, d)


@pytest.mark.parametrize("name", ["cbox", "twins"])
@pytest.mark.parametrize("unroll,dual", [(8, False), (16, True), (32, False)])
def test_q_variant_plain_matches_jax_kernel(sweep, cbox, name, unroll, dual):
    tri_q, anchor, nf, (o, d) = _table(name, cbox)
    mt = np.full(N_RAYS, np.inf, np.float32)
    mt[::7] = 0.8
    jt, jp = map(np.asarray, sweep.q_variant(
        jnp.asarray(tri_q), jnp.asarray(anchor), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(mt), nf, unroll=unroll, dual=dual))
    t, p = (x.numpy() for x in tisect.intersect_q_variant(
        *(torch.as_tensor(x) for x in (tri_q, anchor, o, d, mt)), nf,
        unroll, dual))
    assert p.dtype == np.int32
    same = p == jp
    hit = same & (p >= 0)
    # t at rtol 1e-5 on equal prims; another prim only where rounding
    # decides (XLA contracts the Pallas multiply-adds into FMAs): both hit
    # at the same distance (a shared edge, coplanar faces)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-6)
    assert np.all(np.isinf(t[p < 0])) and np.all(np.isinf(jt[jp < 0]))
    assert (~same).mean() <= 0.01
    np.testing.assert_allclose(t[~same], jt[~same], rtol=1e-4)
    assert 0.1 < (p >= 0).mean() and not (p[::7] >= 0).all()
    if name == "twins":  # the even row of every tied pair wins
        assert (p[p >= 0] % 2 == 0).all() and (jp[jp >= 0] % 2 == 0).all()


@pytest.mark.parametrize("name", ["cbox", "twins"])
@pytest.mark.parametrize("unroll", [8, 32])
def test_occluded_q_variant_plain_matches_jax(cbox, name, unroll):
    """Against `pallas_occluded_q` at finite maxt (the tool's any hit is
    that kernel's test over the rounded rows); an infinite maxt is never
    occluded."""
    tri_q, anchor, nf, (o, d) = _table(name, cbox)
    rng = np.random.default_rng(unroll)
    mt = rng.uniform(0.05, 2.5, N_RAYS).astype(np.float32)
    want = np.asarray(pallas_occluded_q(
        jnp.asarray(tri_q), jnp.asarray(anchor), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(mt), interpret=True, n_tris=nf))
    args = [torch.as_tensor(x) for x in (tri_q, anchor, o, d, mt)]
    got = tisect.occluded_q_variant(*args, nf, unroll)
    # where the flags differ, rounding decides: the closest hit lies within
    # 1e-4 of maxt or on a triangle's boundary
    t, _, u, v = (x.numpy() for x in tisect.intersect_q_plain(
        *args[:4], torch.full_like(args[4], np.inf), nf))
    off = got.numpy() != want
    assert (~off).mean() >= 0.99
    near_end = np.abs(t[off] - mt[off]) <= 1e-4 * mt[off]
    edge = np.minimum(np.minimum(u[off], v[off]), 1 - u[off] - v[off]) < 1e-4
    assert (near_end | edge).all()
    assert 0.05 < got.float().mean() < 0.95
    args[4] = torch.where(torch.arange(N_RAYS) % 3 == 0, float("inf"),
                          args[4])
    got_inf = tisect.occluded_q_variant(*args, nf, unroll)
    assert not got_inf[::3].any()
    keep = torch.arange(N_RAYS) % 3 != 0
    assert torch.equal(got_inf[keep], got[keep])
    # occluded_q takes the same maxt as 3.4e38
    assert tisect.occluded_q(*args, nf)[::3].any()


def test_q_variant_rows_and_arguments():
    # isect_unroll_sweep.py:93-94 / 205-206
    for n_rows, n_tris, unroll in [(64, 36, 8), (64, 36, 32), (64, 64, 16),
                                   (5120, 5120, 32), (64, 36, 2), (40, 36,
                                                                   32)]:
        want = min(-(-n_tris // unroll) * unroll, n_rows - n_rows % unroll)
        assert tisect.q_variant_rows(n_rows, n_tris, unroll) == want
    tri_q, anchor = torch.zeros((64, 16)), torch.zeros(3)
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(ValueError):
        tisect.intersect_q_variant(tri_q, anchor, o, d, mt, 36, unroll=4)
    with pytest.raises(ValueError):
        tisect.occluded_q_variant(tri_q, anchor, o, d, mt, 65, unroll=8)
    with pytest.raises(TypeError):
        tisect.intersect_q_variant(tri_q, anchor, o.double(), d, mt, 36)
    t, prim = tisect.intersect_q_variant(tri_q, anchor, o, d, mt, 36, 32)
    assert (prim == -1).all() and torch.isinf(t).all()


def test_unroll_sweep_tool_runs_on_the_cpu(cbox):
    """The tool's rows on 2,048 sweep rays of the Cornell box: B1 and B2
    first, then every variant; on the CPU the plain versions round as B1's
    plain version does, so the single-accumulator rows equal it on every
    lane; no kernel launches."""
    rays = us.sweep_rays(cbox, 2048, seed=1)
    o, d, mt = rays
    assert torch.isinf(mt).all()
    lo, hi = o.min(0).values, o.max(0).values
    assert (lo > -0.91).all() and (hi < 0.91).all()
    ops.reset_launch_counts()
    rows = us.run(cbox, rays)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert [(r["kind"], r["unroll"], r["dual"]) for r in rows] == (
        [("closest", None, False)]
        + [("closest", u, du) for u, du in us.CLOSEST]
        + [("any hit", None, False)]
        + [("any hit", u, False) for u in us.ANYHIT])
    for r in rows:
        assert r["ms"] is None and r["n"] == 2048
        if r["kind"] == "any hit":
            assert r["occ_agree"] == 1.0, r
        else:
            assert r["prim_agree"] >= (0.99 if r["dual"] else 1.0), r
    assert [r["rows"] for r in rows[1:5]] == [40, 48, 64, 48]
    timed = us.run(cbox, rays, timer=lambda fn: (fn(), 4.0)[1])
    assert all(r["ms_per_mrays"] == 4.0 / (2048 / 1e6) for r in timed)
