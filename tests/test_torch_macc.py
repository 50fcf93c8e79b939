"""The multi-accumulator q closest hit (B11c) against the JAX package on the
CPU: `intersect_q_macc_plain` against the JAX tool's own kernel
(`tools/experiments/isect_q_multiacc.py::intersect_macc`, body
`_q_kernel_macc`, run in interpret mode), the sweep's two accumulators
(B11a dual) against nacc = 2, and the port's tool
(`tools/isect_q_multiacc.py`) on the CPU.

The JAX tool loads cbox.xml, which the repository does not hold, at import
and has no `__main__` guard, so its two functions are taken from its
source with `ast` and run in a namespace of their own."""
import ast
import functools
import importlib.util
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import mitsuba3_plt_tpu.ops.intersect_pallas as ip
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.tools import isect_q_multiacc as qm
from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

N_RAYS = 512
EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "experiments")


def _interpret_pl():
    """`pl` with `pallas_call` forced to interpret mode (no TPU here)."""
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, **{**kw, "interpret": True})

    return types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                 pallas_call=pallas_call)


@pytest.fixture(scope="module")
def macc():
    """`intersect_macc` of the JAX tool, its FunctionDefs executed alone."""
    path = os.path.join(EXPERIMENTS, "isect_q_multiacc.py")
    tree = ast.parse(open(path).read(), filename=path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_q_kernel_macc", "intersect_macc")]
    assert [n.name for n in defs] == ["_q_kernel_macc", "intersect_macc"]
    ns = {"jax": jax, "jnp": jnp, "functools": functools, "pltpu": pltpu,
          "ip": ip, "pl": _interpret_pl(), "SUB": ip.SUB, "LANES": ip.LANES,
          "BLOCK": ip.BLOCK, "UNROLL": 16}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns["intersect_macc"]


@pytest.fixture(scope="module")
def sweep():
    """The unroll-sweep tool as a module, `pallas_call` in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_unroll_sweep_macc", os.path.join(EXPERIMENTS,
                                              "isect_unroll_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _interpret_pl()
    return mod


@pytest.fixture(scope="module")
def cbox():
    return tpresets.cornell_box(16, 16, device="cpu")


def _table(name, cbox):
    """(tri_q, anchor, faces, (o, d), maxt): the Cornell box with the
    sweep's rays, or 20 random triangles each stored in two neighbouring
    rows (every hit an exact tie between rows 2k and 2k + 1) with rays
    through the middle of their box; maxt inf, 0.8 on every seventh lane."""
    mt = np.full(N_RAYS, np.inf, np.float32)
    mt[::7] = 0.8
    if name == "cbox":
        o, d, _ = us.sweep_rays(cbox, N_RAYS, seed=5)
        g = cbox.geo
        return (g.tri_q.numpy(), g.tri_anchor.numpy(), g.n_faces,
                (o.numpy(), d.numpy()), mt)
    rng = np.random.default_rng(8)
    p0 = rng.uniform(-1, 1, (20, 3))
    p1 = p0 + rng.normal(scale=0.6, size=(20, 3))
    p2 = p0 + rng.normal(scale=0.6, size=(20, 3))
    tri_q, anchor = tisect.pack_tri_q(*(np.repeat(x, 2, axis=0)
                                        for x in (p0, p1, p2)))
    o = rng.uniform(-0.5, 0.5, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return tri_q, anchor, 40, (o, d), mt


def _jax(fn, tri_q, anchor, o, d, mt, *args, **kw):
    return [np.asarray(x) for x in fn(
        jnp.asarray(tri_q), jnp.asarray(anchor), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(mt), *args, **kw)]


def _port(fn, tri_q, anchor, o, d, mt, *args):
    return [x.numpy() for x in fn(
        *(torch.as_tensor(x) for x in (tri_q, anchor, o, d, mt)), *args)]


@pytest.mark.parametrize("name", ["cbox", "twins"])
@pytest.mark.parametrize("nacc", [2, 4, 8])
def test_macc_plain_matches_jax_kernel(macc, cbox, name, nacc):
    tri_q, anchor, nf, (o, d), mt = _table(name, cbox)
    jt, jp, ju, jv = _jax(macc, tri_q, anchor, o, d, mt, n_tris=nf,
                          nacc=nacc)
    t, p, u, v = _port(tisect.intersect_q_macc_plain, tri_q, anchor, o, d,
                       mt, nf, nacc)
    assert p.dtype == np.int32 and jp.dtype == np.int32
    same = p == jp
    hit = same & (p >= 0)
    # t, u, v at rtol 1e-5 / atol 1e-6 on equal prims (XLA contracts the
    # Pallas multiply-adds into FMAs, the plain version rounds each
    # product and sum); another prim only where rounding decides: both hit
    # at the same distance (a shared edge, coplanar or twin faces)
    for a, b in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-6)
    assert np.all(np.isinf(t[p < 0])) and np.all(np.isinf(jt[jp < 0]))
    assert np.all(u[p < 0] == 0) and np.all(ju[jp < 0] == 0)
    assert (~same).mean() <= 0.01
    np.testing.assert_allclose(t[~same], jt[~same], rtol=1e-4)
    assert 0.1 < (p >= 0).mean() and not (p[::7] >= 0).all()
    if name == "twins":  # a tie across groups goes to the lower group
        assert (p[p >= 0] % 2 == 0).all() and (jp[jp >= 0] % 2 == 0).all()


@pytest.mark.parametrize("name", ["cbox", "twins"])
def test_macc_two_groups_is_the_sweeps_dual(macc, sweep, cbox, name):
    """nacc = 2 and the unroll sweep's two accumulators (B11a, dual) are
    one function on these rays: the JAX tool's two kernels agree on prim
    and t to the bit, and so do the port's two plain versions (which share
    the merge), so one CUDA template serves both."""
    tri_q, anchor, nf, (o, d), mt = _table(name, cbox)
    jt, jp, _, _ = _jax(macc, tri_q, anchor, o, d, mt, n_tris=nf, nacc=2)
    st, sp = _jax(sweep.q_variant, tri_q, anchor, o, d, mt, nf, unroll=16,
                  dual=True)
    np.testing.assert_array_equal(sp, jp)
    np.testing.assert_array_equal(st, jt)
    t, p, _, _ = _port(tisect.intersect_q_macc_plain, tri_q, anchor, o, d,
                       mt, nf, 2)
    vt, vp = _port(tisect.intersect_q_variant_plain, tri_q, anchor, o, d,
                   mt, nf, 16, True)
    np.testing.assert_array_equal(vp, p)
    np.testing.assert_array_equal(vt, t)


def test_dual_merge_differs_only_at_maxt():
    """Where B11a's JAX merge (`isect_unroll_sweep.py:68`: ts2 |det|1 <
    ts1 |det|2, no test of which group hit) and the port's merge part:
    group 0 missed and holds (maxt, 1); group 1 took row A, then row B, each
    by the groups' strict cross-multiplied compare, but B lies within
    rounding of maxt, so ts_B < maxt |det|_B fails although each step
    passed. The JAX merge keeps the miss, the port's keeps B. With maxt
    away from B's t the two agree."""
    f = np.float32
    maxt, ad_a, ts_a = f(2.4917126), f(1.5785382), f(3.9332633)
    ad_b, ts_b = f(0.21272549), f(0.53005075)
    assert ts_a * f(1) < maxt * ad_a      # A beats the empty group
    assert ts_b * ad_a < ts_a * ad_b      # B beats A
    assert not ts_b * f(1) < maxt * ad_b  # yet B does not beat maxt

    def merged(mt):
        def t(v):
            return torch.tensor([v], dtype=torch.float32)

        miss = (t(mt), t(1.0), t(0.0), t(0.0),
                torch.tensor([-1], dtype=torch.int32))
        hit = (t(ts_b), t(ad_b), t(0.1), t(0.1),
               torch.tensor([7], dtype=torch.int32))
        port = tisect._merge_groups([miss, hit])[4].item()
        jax_win = bool(hit[0] * miss[1] < miss[0] * hit[1])
        return port, 7 if jax_win else -1

    assert merged(maxt) == (7, -1)
    assert merged(f(4.0)) == (7, 7)


def test_macc_rows_groups_and_arguments(cbox):
    """The rows run (isect_q_multiacc.py:102), the group rule, and the
    wrapper's checks. Rows 1 and 2 hold one triangle twice: B1 takes the
    first, row 1; at nacc 2 they lie in groups 1 and 0 and the tie goes to
    group 0, row 2; at nacc 4 and 8 in groups 1 and 2, so row 1."""
    for n_rows, n_tris in [(64, 36), (64, 64), (5120, 5120), (64, 1)]:
        want = min(-(-n_tris // 16) * 16, n_rows)
        assert tisect.q_variant_rows(n_rows, n_tris, 16) == want
    p0 = np.array([[5.0, -1, -1], [-1, -1, 2], [-1, -1, 2]])
    e = np.array([[0.0, 3, 0], [0, 3, 0], [0, 3, 0]])
    f = np.array([[0.0, 0, 3], [3, 0, 0], [3, 0, 0]])
    tri_q, anchor = tisect.pack_tri_q(p0, p0 + e, p0 + f)
    o = torch.tensor([[0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    mt = torch.tensor([np.inf], dtype=torch.float32)
    q = (torch.as_tensor(tri_q), torch.as_tensor(anchor), o, d, mt)
    assert tisect.intersect_q(*q, 3)[1].item() == 1
    for nacc in (2, 4, 8):
        t, p, u, v = tisect.intersect_q_macc(*q, 3, nacc)
        assert p.item() == (2 if nacc == 2 else 1), nacc
        assert t.item() == pytest.approx(2.0)
    with pytest.raises(ValueError):
        tisect.intersect_q_macc(*q, 3, 3)
    with pytest.raises(ValueError):
        tisect.intersect_q_macc(*q, 65, 2)
    with pytest.raises(TypeError):
        tisect.intersect_q_macc(q[0], q[1], o.double(), d, mt, 3, 2)
    t, p, u, v = tisect.intersect_q_macc(torch.zeros((64, 16)),
                                         torch.zeros(3), o, d, mt, 36, 8)
    assert (p == -1).all() and torch.isinf(t).all() and (u == 0).all()


def test_multiacc_tool_runs_on_the_cpu(cbox):
    """The tool's rows on 2,048 sweep rays of the Cornell box: B1 first,
    then nacc 2, 4 and 8; no kernel launches on the CPU."""
    rays = us.sweep_rays(cbox, 2048, seed=1)
    ops.reset_launch_counts()
    rows = qm.run(cbox, rays)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert [r["nacc"] for r in rows] == [None, 2, 4, 8]
    assert [r["rows"] for r in rows] == [36, 48, 48, 48]
    for r in rows:
        assert r["ms"] is None and r["n"] == 2048
        # ties across groups pick another of two coplanar or touching
        # faces than B1 on a few lanes
        assert r["prim_agree"] >= 0.99, r
        assert r["hit_share"] == rows[0]["hit_share"]
    timed = qm.run(cbox, rays, timer=lambda fn: (fn(), 2.0)[1])
    assert all(r["ms_per_mrays"] == 2.0 / (2048 / 1e6) for r in timed)
