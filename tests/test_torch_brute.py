"""The classic brute force (B8) and the MXU-form brute force (B9) of the
port against the JAX package's Pallas kernels in interpret mode (CPU), on
the Cornell box's triangles and on random triangles that each appear twice
(every hit an exact tie, which the first copy must win), with camera,
bounce, random and grazing rays; the MXU table packer; and the
intersection bench tool on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pack_tri_mxu as j_pack_tri_mxu, pallas_intersect, pallas_intersect_mxu,
    pallas_occluded,
)
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

N_RAYS = 8192  # one Pallas block


def _rows(p0, p1, p2):
    """[F_pad, 9] (p0, e1, e2) rows padded to a multiple of 64."""
    rows = np.concatenate([p0, p1 - p0, p2 - p0], -1).astype(np.float32)
    return np.concatenate([rows, np.zeros(((-len(rows)) % 64, 9),
                                          np.float32)])


@pytest.fixture(scope="module")
def cbox():
    return tpresets.cornell_box(32, 32, device="cpu")


def _table(name, cbox):
    """(rows [F_pad, 9], n_faces)."""
    if name == "cbox":
        return cbox.geo.tri_isect.numpy(), cbox.geo.n_faces
    rng = np.random.default_rng(21)
    p0 = rng.uniform(-1, 1, (150, 3))
    p1 = p0 + rng.normal(scale=0.4, size=(150, 3))
    p2 = p0 + rng.normal(scale=0.4, size=(150, 3))
    p = [np.repeat(x, 2, axis=0).astype(np.float32) for x in (p0, p1, p2)]
    return _rows(*p), 300


def _grazing(rows, n_faces, n, rng):
    """Rays that meet a triangle at a shallow angle, 3 to 10 degrees off its
    plane, at an inner point (barycentrics at least 0.02 from every edge),
    from either side: a small determinant, so rounding moves u, v and t
    the most."""
    tri = rows[rng.integers(0, n_faces, n)]
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    b = rng.dirichlet((1.0, 1.0, 1.0), n) * 0.94 + 0.02
    target = p0 + e1 * b[:, 1:2] + e2 * b[:, 2:3]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    along = rng.normal(size=(n, 3))
    along -= nrm * np.einsum("ij,ij->i", along, nrm)[:, None]
    along /= np.linalg.norm(along, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.uniform(3.0, 10.0, (n, 1)))
    side = np.where(rng.random((n, 1)) < 0.5, 1.0, -1.0)
    d = along * np.cos(ang) + nrm * side * np.sin(ang)
    o = target - d * rng.uniform(0.05, 0.5, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _check_closest(got, want, rtol_t=1e-5, rtol_uv=1e-5, atol_uv=1e-5):
    """Closest hits (t, prim, u, v) against a reference's. On equal prims,
    t at rtol rtol_t / atol 1e-6 and u, v at rtol rtol_uv / atol atol_uv
    (1e-5 and 1e-5 for the classic form: XLA contracts the Pallas kernel's
    multiply-adds into FMAs on the CPU and the port rounds every product
    and sum, which moves u and v by up to ~4e-6 on lanes with a small
    determinant). A lane whose prims
    differ must be one that rounding decides: both hit the same point (a
    ray through a shared edge or vertex, or onto two coplanar faces, as the
    Cornell box's floor and the bottoms of its boxes), or one misses and
    the other's hit lies on its triangle's boundary (a crack). Returns the
    share of such lanes."""
    t, prim, u, v = got
    jt, jprim, ju, jv = want
    same = prim == jprim
    hit = same & (prim >= 0)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=rtol_t, atol=1e-6)
    np.testing.assert_allclose(u[hit], ju[hit], rtol=rtol_uv, atol=atol_uv)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=rtol_uv, atol=atol_uv)
    assert np.all(np.isinf(t[prim < 0]))
    diff = ~same
    both = diff & (prim >= 0) & (jprim >= 0)
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)

    def on_edge(uu, vv):
        return np.minimum(np.minimum(uu, vv), 1.0 - uu - vv) < 1e-4

    one = diff & ~both
    mine = one & (prim >= 0)
    assert on_edge(u[mine], v[mine]).all()
    theirs = one & (jprim >= 0)
    assert on_edge(ju[theirs], jv[theirs]).all()
    return diff.mean()


def _rays(kind, table, rows, n_faces, cbox):
    rng = np.random.default_rng(len(kind) * 7 + len(table))
    if kind in ("camera", "bounce"):
        sets = bi.cbox_ray_sets(cbox, N_RAYS // (32 * 32), seed=3)
        o, d, _ = sets["depth0" if kind == "camera" else "depth1"]
        return o.numpy(), d.numpy()
    if kind == "grazing":
        return _grazing(rows, n_faces, N_RAYS, rng)
    o = rng.uniform(-1.5, 1.5, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


CASES = [("cbox", "camera"), ("cbox", "bounce"), ("cbox", "grazing"),
         ("twins", "random"), ("twins", "grazing")]


def _maxt(n, rng):
    mt = rng.uniform(0.2, 4.0, n).astype(np.float32)
    mt[::3] = np.inf
    mt[1::17] = 0.0
    return mt


@pytest.mark.parametrize("table,kind", CASES)
def test_intersect_classic_plain_matches_pallas(cbox, table, kind):
    rows, nf = _table(table, cbox)
    o, d = _rays(kind, table, rows, nf, cbox)
    mt = _maxt(N_RAYS, np.random.default_rng(5))
    want = tuple(map(np.asarray, pallas_intersect(
        jnp.asarray(rows), jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True, n_tris=nf)))
    got = tuple(x.numpy() for x in tisect.intersect_classic(
        torch.as_tensor(rows), torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(mt), n_tris=nf))
    assert got[1].dtype == np.int32
    frac = _check_closest(got, want)
    print(f"prims differ on {frac:.5f} of lanes")
    hit = got[1] >= 0
    assert hit.mean() > 0.1 and not hit[1::17].any()
    if table == "twins":  # the first of two equal rows wins every tie
        assert (got[1][hit] % 2 == 0).all()


@pytest.mark.parametrize("table,kind", CASES)
def test_occluded_classic_plain_matches_pallas(cbox, table, kind):
    rows, nf = _table(table, cbox)
    o, d = _rays(kind, table, rows, nf, cbox)
    mt = _maxt(N_RAYS, np.random.default_rng(6))
    want = np.asarray(pallas_occluded(
        jnp.asarray(rows), jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True, n_tris=nf))
    counts = {}
    got = tisect.occluded_classic_plain(
        torch.as_tensor(rows), torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(mt), n_tris=nf, counts=counts).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95
    # a lane tests triangles up to its first hit
    assert N_RAYS * 1 <= counts["triangle_tests"] < N_RAYS * nf


@pytest.mark.parametrize("order", ["random", "strided"])
@pytest.mark.parametrize("table", ["cbox", "twins"])
def test_occluded_classic_plain_ignores_row_order(cbox, table, order):
    """The any hit is an OR over rows, which its kernels rely on when they
    split a ray's rows among the lanes of a tile: the plain version gives
    the same answer over its rows in a random order and in the order of a
    tile of 32 lanes taken lane by lane (rows l, l + 32, ... of lane l)."""
    rows, nf = _table(table, cbox)
    o, d = _rays("random", table, rows, nf, cbox)
    rng = np.random.default_rng(7)
    mt = _maxt(N_RAYS, rng)
    perm = (rng.permutation(nf) if order == "random" else
            np.concatenate([np.arange(lane, nf, 32) for lane in range(32)]))
    assert sorted(perm) == list(range(nf))
    args = tuple(torch.as_tensor(x) for x in (o, d, mt))
    want = tisect.occluded_classic_plain(torch.as_tensor(rows), *args, nf)
    got = tisect.occluded_classic_plain(torch.as_tensor(rows[perm]), *args,
                                        nf)
    assert torch.equal(got, want)
    assert 0.05 < want.float().mean() < 0.95


def test_pack_tri_mxu_matches_jax(cbox):
    rows, nf = _table("twins", cbox)
    p0, e1, e2 = rows[:nf, 0:3], rows[:nf, 3:6], rows[:nf, 6:9]
    want = j_pack_tri_mxu(p0, e1, e2)
    got = tisect.pack_tri_mxu(p0, e1, e2)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4 * nf, 16) and got.dtype == np.float32
    w = tisect.regroup_tri_mxu(got)
    assert w.shape == (4 * 384, 16)
    for c in range(4):
        np.testing.assert_array_equal(w[c * 384: c * 384 + nf],
                                      got[c * nf: (c + 1) * nf])
        assert not w[c * 384 + nf: (c + 1) * 384].any()


@pytest.mark.parametrize("table,kind", CASES)
def test_intersect_mxu_plain_matches_pallas(cbox, table, kind):
    """B9's tolerance: hit masks equal on >= 99.99% of lanes (all 8,192
    here), t within rtol 1e-4 where both hit, u and v at rtol 1e-3 / atol
    1e-4 (the product cancels large terms); prims equal but where rounding
    decides (`_check_closest`). The same rule holds against the classic
    plain version."""
    rows, nf = _table(table, cbox)
    o, d = _rays(kind, table, rows, nf, cbox)
    mt = _maxt(N_RAYS, np.random.default_rng(7))
    w = tisect.regroup_tri_mxu(tisect.pack_tri_mxu(
        rows[:nf, 0:3], rows[:nf, 3:6], rows[:nf, 6:9]))
    want = tuple(map(np.asarray, pallas_intersect_mxu(
        jnp.asarray(w), jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True)))
    args = [torch.as_tensor(x) for x in (o, d, mt)]
    got = tuple(x.numpy() for x in tisect.intersect_mxu(
        torch.as_tensor(w), *args))
    assert got[1].dtype == np.int32
    hit = got[1] >= 0
    assert (hit == (want[1] >= 0)).mean() >= 1 - 1e-4
    assert hit.mean() > 0.1
    assert np.all(np.isinf(got[0][~hit])) and (got[2][~hit] == 0).all()
    tol = dict(rtol_t=1e-4, rtol_uv=1e-3, atol_uv=1e-4)
    print("prims differ from Pallas on", _check_closest(got, want, **tol))
    classic = tuple(x.numpy() for x in tisect.intersect_classic_plain(
        torch.as_tensor(rows), *args, n_tris=nf))
    print("from classic on", _check_closest(got, classic, **tol))


def test_intersect_mxu_plain_chunks_agree(cbox, monkeypatch):
    rows, nf = _table("cbox", cbox)
    o, d = _rays("bounce", "cbox", rows, nf, cbox)
    args = [torch.as_tensor(x) for x in (o, d, np.full(N_RAYS, np.inf,
                                                       np.float32))]
    w = torch.as_tensor(tisect.regroup_tri_mxu(tisect.pack_tri_mxu(
        rows[:nf, 0:3], rows[:nf, 3:6], rows[:nf, 6:9])))
    whole = tisect.intersect_mxu_plain(w, *args)
    # the zero rows past the faces never hit: skipping them changes nothing
    faces = tisect.intersect_mxu_plain(w, *args, n_tris=nf)
    monkeypatch.setattr(tisect, "MXU_CHUNK", 1000)
    parts = tisect.intersect_mxu_plain(w, *args)
    assert (whole[1] >= 0).float().mean() > 0.5
    for a, b, c in zip(whole, parts, faces):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_brute_wrappers_check_arguments():
    tri = torch.zeros((64, 9))
    w = torch.zeros((512, 16))
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(TypeError):
        tisect.intersect_classic(tri, o.double(), d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_classic(tri, o, d[:4], mt)
    with pytest.raises(ValueError):
        tisect.intersect_classic(torch.zeros((64, 16)), o, d, mt)
    with pytest.raises(ValueError):
        tisect.intersect_classic(tri, o, d, mt, n_tris=65)
    with pytest.raises(ValueError):
        tisect.intersect_mxu(w[:510], o, d, mt)
    with pytest.raises(ValueError):
        tisect.intersect_mxu(w, o, d, mt, n_tris=129)
    for nt in (None, 0, 7):
        t, prim, u, v = tisect.intersect_mxu(w, o, d, mt, n_tris=nt)
        assert (prim == -1).all() and torch.isinf(t).all()
        assert (u == 0).all() and (v == 0).all()
    t, prim, _, _ = tisect.intersect_classic(tri, o, d, mt)
    assert (prim == -1).all() and torch.isinf(t).all()


def test_bench_tool_runs_on_the_cpu(cbox):
    """The tool's routes on 4,096 rays of each set: every closest route
    agrees with brute-classic on hit or miss, the q, MXU and packet
    routes to rounding, and no kernel launches on the CPU."""
    sets = {**bi.ray_sets(cbox, 4096, 0), **bi.cbox_ray_sets(cbox, 4, 0)}
    assert set(sets) == {"coherent", "incoherent", "depth0", "depth1",
                         "depth2", "depth3", "shadow0", "shadow1",
                         "shadow2", "shadow3"}
    o, d, mt = sets["coherent"]
    assert o.shape == (4096, 3) and torch.isinf(mt).all()
    assert (o == o[0]).all() and (d[:, 2] > 0.8).all()
    ops.reset_launch_counts()
    rows = bi.run(cbox, sets)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert len(rows) == 6 * 7 + 4 * 2
    for r in rows:
        assert r["ms"] is None and r["n"] == 4096
        if r["route"] in bi.ANYHIT:
            assert r["occ_agree"] >= 0.995, r
        else:
            assert r["hit_agree"] >= 0.999 and r["prim_agree"] >= 0.99, r
            assert r["max_rel_t_err"] < 1e-4, r
    # with a timer, each route asked for is timed once per set
    calls = []
    timed = bi.run(cbox, {"depth1": sets["depth1"], "shadow1":
                          sets["shadow1"]}, routes=("brute-q", "anyhit-q"),
                   timer=lambda fn: calls.append(fn()) or 2.0)
    assert [(r["set"], r["route"]) for r in timed] == [
        ("depth1", "brute-q"), ("depth1", "anyhit-q"),
        ("shadow1", "anyhit-q")]
    assert len(calls) == 3
    assert all(r["ms"] == 2.0 and r["mrays_per_s"] == 4096 / 2.0 / 1e3
               for r in timed)


def test_cbox_tri_isect_matches_jax_geometry():
    jscene, _ = jpresets.cornell_box(8, 8)
    port = tpresets.cornell_box(8, 8, device="cpu")
    np.testing.assert_array_equal(port.geo.tri_isect.numpy(),
                                  np.asarray(jscene.geo.tri_isect))
