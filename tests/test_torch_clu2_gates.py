"""The clu2 walk's gates above the supers (`ops/intersect.py::clu2_gates`;
`intersect_clu2_plain` / `occluded_clu2_plain`, the plain versions of
`csrc/intersect_clu2.cu`) on the CPU: the gated walk against the DFS walk
without the gates (`intersect_clu2_dfs`, `occluded_clu2_dfs`) lane for
lane, against the Pallas clu2 kernels in interpret mode, the gate boxes,
the tests they save and the tie rule, on the small tables of
tests/test_torch_mesh.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pallas_intersect_clu2, pallas_occluded_clu2,
)
from mitsuba3_plt_tpu.scene.bvh import build_bvh as j_build_bvh
from mitsuba3_plt_tpu.scene.bvh import pack_clusters2 as j_pack_clusters2
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene.bvh import (ClusterTable2, build_bvh,
                                              pack_clusters2)
from test_torch_mesh import CT_FIELDS, _mesh_of, _rays, _soup

NAMES = ["spheres", "sphere20k", "twins"]


@pytest.fixture(scope="module")
def tables():
    """{name: (JAX ClusterTable2, port ClusterTable2)}."""
    out = {}
    for name in NAMES:
        p = _soup(name)
        verts, faces = _mesh_of(p)
        out[name] = (j_pack_clusters2(j_build_bvh(verts, faces), *p),
                     pack_clusters2(build_bvh(verts, faces), *p,
                                    device="cpu"))
    return out


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _closest_rays(name, n, seed):
    """`_rays` with some segments ending before the geometry and some
    canonical dead rays (o = 1e8, d = +z) among them."""
    o, d = _rays(name, n, seed)
    mt = np.full(n, np.inf, np.float32)
    mt[::9] = 4.5
    o[3::23], d[3::23] = 1e8, (0.0, 0.0, 1.0)
    return o, d, mt


@pytest.mark.parametrize("name", NAMES)
def test_gated_walk_equals_dfs_walk(tables, name):
    """The gates change no result: prim, t, u and v of the closest hit and
    the any hit's flags equal the DFS walk's without the gates on every
    lane, while the cluster and triangle tests are the same."""
    _, tct = tables[name]
    o, d, mt = _t(*_closest_rays(name, 1024, seed=20 + len(name)))
    gated, dfs = {}, {}
    got = tisect.intersect_clu2_plain(tct, o, d, mt, counts=gated)
    want = tisect.intersect_clu2_dfs(tct, o, d, mt, counts=dfs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[1] >= 0).float().mean() > 0.3
    for key in ("cluster_tests", "triangle_tests"):
        assert gated[key] == dfs[key] > 0
    short = torch.full_like(mt, 4.5)
    assert torch.equal(tisect.occluded_clu2_plain(tct, o, d, short),
                       tisect.occluded_clu2_dfs(tct, o, d, short))


@pytest.mark.parametrize("name", NAMES)
def test_gated_walk_matches_jax_kernel(tables, name):
    """The JAX clu2 tests' tolerances: prim on >= 99.9% of lanes (ties at
    shared edges), t at 2e-5, u and v at rtol 1e-3 / atol 1e-4 (XLA
    contracts the kernel's multiply-adds on the CPU)."""
    jct, tct = tables[name]
    o, d, mt = _closest_rays(name, 1024, seed=30 + len(name))
    jt, jp, ju, jv = map(np.asarray, pallas_intersect_clu2(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True))
    t, p, u, v = (x.numpy() for x in tisect.intersect_clu2_plain(
        tct, *_t(o, d, mt)))
    assert (p == jp).mean() >= 0.999, (p == jp).mean()
    same = (p >= 0) & (p == jp)
    assert same.mean() > 0.3
    np.testing.assert_allclose(t[same], jt[same], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-3, atol=1e-4)
    assert np.all(np.isinf(t[p < 0]))


@pytest.mark.parametrize("name", NAMES)
def test_gated_anyhit_matches_jax_kernel_and_dfs(tables, name):
    """The any hit against the Pallas kernel on >= 99.9% of lanes, and equal
    to the DFS any hit without the gates on every lane."""
    jct, tct = tables[name]
    o, d = _rays(name, 1024, seed=40 + len(name))
    t0 = tisect.intersect_clu2_plain(
        tct, *_t(o, d, np.full(1024, np.inf, np.float32)))[0].numpy()
    rng = np.random.default_rng(13)
    # segments ending just short of / past the closest hit, random ones,
    # infinite and empty ones, and dead rays
    frac = rng.choice([0.95, 1.05], 1024)
    mt = np.where(np.isfinite(t0), t0 * frac, rng.uniform(0, 9, 1024))
    mt[::13] = np.inf
    mt[5::17] = 0.0
    mt = mt.astype(np.float32)
    o[7::29], d[7::29] = 1e8, (0.0, 0.0, 1.0)
    want = np.asarray(pallas_occluded_clu2(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True))
    got = tisect.occluded_clu2_plain(tct, *_t(o, d, mt)).numpy()
    assert (got == want).mean() >= 0.999
    assert 0.1 < got.mean() < 0.9
    np.testing.assert_array_equal(
        got, tisect.occluded_clu2_dfs(tct, *_t(o, d, mt)).numpy())


@pytest.mark.parametrize("any_hit", [False, True])
def test_dead_rays_stop_at_the_root(tables, any_hit):
    """The canonical dead ray (o = 1e8, d = +z; maxt inf, or 0 for a
    shadow ray) does one root test and nothing more, and misses."""
    _, tct = tables["sphere20k"]
    n = 256
    o = torch.full((n, 3), 1e8)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    counts = {}
    if any_hit:
        occ = tisect.occluded_clu2_plain(tct, o, d, torch.zeros(n),
                                         counts=counts)
        assert not occ.any()
    else:
        t, p, u, v = tisect.intersect_clu2_plain(
            tct, o, d, torch.full((n,), float("inf")), counts=counts)
        assert (p == -1).all() and torch.isinf(t).all()
        assert (u == 0).all() and (v == 0).all()
    assert counts == {"root_tests": n, "group_tests": 0, "super_tests": 0,
                      "cluster_tests": 0, "triangle_tests": 0}


@pytest.mark.parametrize("name", NAMES)
def test_gates_save_super_tests(tables, name):
    """A lane inside the root box tests every group and then only the
    supers of the groups it enters: fewer super tests than the DFS walk's
    every super a lane, and the same cluster and triangle tests."""
    _, tct = tables[name]
    o, d, mt = _t(*_closest_rays(name, 1024, seed=50 + len(name)))
    gated, dfs = {}, {}
    tisect.intersect_clu2_plain(tct, o, d, mt, counts=gated)
    tisect.intersect_clu2_dfs(tct, o, d, mt, counts=dfs)
    assert gated["root_tests"] == 1024
    n_groups = tct.groups.shape[0]
    assert 0 < gated["group_tests"] <= 1024 * n_groups
    assert gated["group_tests"] % n_groups == 0
    n_supers = tct.supers.shape[0]
    assert gated["super_tests"] < dfs["super_tests"] == 1024 * n_supers
    assert gated["triangle_tests"] == dfs["triangle_tests"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_a_ray_in_a_super_is_in_its_group_and_the_root(tables, name):
    """The slab test is monotone in the box planes: every (ray, super) pair
    that passes near <= far, far > 0 also passes it for the super's group
    and the root box, with near no greater and far no smaller."""
    _, tct = tables[name]
    o, d, _ = _t(*_closest_rays(name, 1024, seed=60 + len(name)))
    o = o - tct.anchor
    inv = 1.0 / tisect._signed_eps(d)

    def slab(box, o, inv):  # _CluWalk.slab over a batch of boxes
        t0 = (box[..., 0:3] - o) * inv
        t1 = (box[..., 3:6] - o) * inv
        return (torch.minimum(t0, t1).amax(-1),
                torch.maximum(t0, t1).amin(-1))

    sup = tct.supers[tct.supers[:, 7] > 0]
    of = torch.arange(sup.shape[0]) // tisect.CLU2_GROUP
    n_s, f_s = slab(sup[:, None], o, inv)
    n_g, f_g = slab(tct.groups[of][:, None], o, inv)
    n_r, f_r = slab(tct.root, o, inv)
    ent = (n_s <= f_s) & (f_s > 0)
    assert ent.any()
    assert (n_g[ent] <= n_s[ent]).all() and (f_g[ent] >= f_s[ent]).all()
    assert (n_r.expand_as(n_s)[ent] <= n_s[ent]).all()
    assert (f_r.expand_as(f_s)[ent] >= f_s[ent]).all()


def _quad_table(order):
    """Two coplanar triangles of the unit square in z = 0 that share the
    diagonal (0, 0)-(1, 1), in the given face order."""
    tris = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                     [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)[order]
    p = [np.ascontiguousarray(tris[:, k]) for k in range(3)]
    verts, faces = _mesh_of(p)
    return pack_clusters2(build_bvh(verts, faces), *p, device="cpu")


@pytest.mark.parametrize("order", [[0, 1], [1, 0]])
def test_tie_goes_to_the_lower_table_position(order):
    """Rays along +z through the shared edge hit both triangles at exactly
    t = 2 (every term is exact): both walks return the face at the lower
    position (4 x row + slot) of the table."""
    ct = _quad_table(order)
    faces = ct.rows.view(-1, 32)[:, 16]
    first = int(faces[faces >= 0][0])
    s = np.arange(1, 8, dtype=np.float32) / 8
    o = np.stack([s, s, np.full_like(s, -2.0)], -1)
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (len(s), 1))
    mt = np.full(len(s), np.inf, np.float32)
    for walk in (tisect.intersect_clu2_plain, tisect.intersect_clu2_dfs):
        t, p, _, _ = walk(ct, *_t(o, d, mt))
        assert (t == 2.0).all() and (p == first).all(), (walk, p)
    # off the edge each triangle is found on its own
    o2 = np.float32([[0.75, 0.25, -2.0], [0.25, 0.75, -2.0]])
    p = tisect.intersect_clu2_plain(ct, *_t(o2, d[:2], mt[:2]))[1]
    assert p.tolist() == [order.index(0), order.index(1)]


@pytest.mark.parametrize("name", NAMES)
def test_root_and_group_boxes(tables, name):
    """The root box and the group boxes are the exact least and greatest
    planes of the supers that hold clusters (all of them, and each run of
    CLU2_GROUP), the same for the table packed here and for the one the
    bridge builds from the JAX package's leaves; every super lies in its
    group's box."""
    jct, tct = tables[name]
    sup = tct.supers.numpy()
    real = sup[sup[:, 7] > 0]
    want = np.concatenate([real[:, 0:3].min(0), real[:, 3:6].max(0),
                           [0.0, 0.0]]).astype(np.float32)
    g = tisect.CLU2_GROUP
    groups = np.stack([np.concatenate([
        real[s: s + g, 0:3].min(0), real[s: s + g, 3:6].max(0),
        [s, len(real[s: s + g])]]) for s in range(0, len(real), g)])
    bridged = ClusterTable2(**{f: torch.as_tensor(np.array(getattr(jct, f)))
                               for f in CT_FIELDS})
    for ct in (tct, bridged):
        assert ct.root.dtype == ct.groups.dtype == torch.float32
        np.testing.assert_array_equal(ct.root.numpy(), want)
        np.testing.assert_array_equal(ct.groups.numpy(),
                                      groups.astype(np.float32))
    of = np.arange(len(real)) // g
    assert (groups[of, 0:3] <= real[:, 0:3]).all()
    assert (groups[of, 3:6] >= real[:, 3:6]).all()


def test_empty_batches(tables):
    """No rays give empty results."""
    _, tct = tables["spheres"]
    e = torch.empty((0, 3))
    t, p, u, v = tisect.intersect_clu2_plain(tct, e, e, torch.empty(0))
    assert t.shape == p.shape == u.shape == v.shape == (0,)
    assert tisect.occluded_clu2_plain(tct, e, e, torch.empty(0)).shape == (0,)


def test_wrappers_check_the_gates(tables):
    """A table whose root or groups are not [8] / [G, 8] float32 on the
    rays' device is refused."""
    import dataclasses

    _, tct = tables["spheres"]
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    for arg, bad in (("root", torch.zeros(6)),
                     ("groups", tct.groups.double()),
                     ("groups", tct.groups[:, :6].contiguous())):
        ct = dataclasses.replace(tct)
        object.__setattr__(ct, arg, bad)
        with pytest.raises(ValueError):
            tisect.intersect_clu2(ct, o, d, mt)
        with pytest.raises(ValueError):
            tisect.occluded_clu2(ct, o, d, mt)
