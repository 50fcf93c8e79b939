"""The packet-BVH route of the port against the JAX package (CPU): the
packet tables and the WideBVH collapsed from them, the plain walks over
the WideBVH (closest and any hit) against the Pallas packet kernels in
interpret mode, against the brute-force oracle, against the port's clu2
walk and against the skip-link walks they replaced, the coherence sort,
the bridge's `pbvh.*` leaves and the routing. More of the any-hit walk:
tests/test_torch_anyhit_wide.py."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pallas_bvh_intersect, pallas_bvh_occluded,
)
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu.scene.bvh import build_bvh as j_build_bvh
from mitsuba3_plt_tpu.scene.bvh import pack_packet_bvh as j_pack_packet_bvh
from mitsuba3_plt_tpu.scene.intersect import brute_force_intersect
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.librender.records import Ray
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
from mitsuba3_plt_tpu_torch.scene.bvh import (
    WIDE, build_bvh, pack_clusters2, pack_packet_bvh, pack_wide_bvh,
)
from test_torch_mesh import _mesh_of, _soup, jax_mesh_scene
from test_torch_scene import jax_scene_arrays


def _sphere4():
    m = jshape.make_sphere(subdiv=4)  # 5,120 faces
    v, f = np.asarray(m.vertices), np.asarray(m.faces)
    return [v[f[:, c]] for c in range(3)]


@pytest.fixture(scope="module")
def tables():
    """{name: (p, JAX PacketBVH, port PacketBVH, port WideBVH)}: the
    5,120-face sphere of tests/test_bvh_pallas.py, the three spheres over a
    plane, and the sphere whose every face appears twice (every hit an
    exact tie)."""
    out = {}
    for name in ("sphere4", "spheres", "twins"):
        p = _sphere4() if name == "sphere4" else _soup(name)
        verts, faces = _mesh_of(p)
        jpb = j_pack_packet_bvh(j_build_bvh(verts, faces), *p)
        tpb = pack_packet_bvh(build_bvh(verts, faces), *p, device="cpu")
        out[name] = (p, jpb, tpb, pack_wide_bvh(tpb))
    return out


def _rays(n, seed=0):
    """The rays of tests/test_bvh_pallas.py::_rays: origins on the sphere of
    radius 3, half aimed near the centre, half in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = target - o
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("name", ["sphere4", "spheres", "twins"])
def test_pack_packet_bvh_bit_identical(tables, name):
    _, jpb, tpb, _ = tables[name]
    for field in ("nodes", "tri"):
        got = getattr(tpb, field)
        assert got.dtype == torch.float32, field
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jpb, field)),
                                      err_msg=field)
    assert tpb.nodes.shape[0] % 8 == 0 and tpb.tri.shape[0] % 8 == 0
    if name == "sphere4":
        assert tuple(tpb.tri.shape) == (5120, 16)
    # leaves hold at most 16 triangles and tile the rows in order
    nd = tpb.nodes.numpy()
    leaves = nd[nd[:, 7] > 0]
    assert leaves[:, 7].max() <= 16
    np.testing.assert_array_equal(np.cumsum(leaves[:, 7])[:-1],
                                  leaves[1:, 6])


def _wide_invariants(twb, tpb):
    """Check the WideBVH against its PacketBVH: every row in exactly one
    leaf slot (so every face of the table in exactly one leaf), each slot's
    box containing its subtree (the boxes of an inner child's slots, the
    vertices of a leaf's rows), an inner child linking a later node that
    no other slot links, the lower slot holding the lower rows, and the
    leaves of at most PACKET_LEAF rows. Returns the rows' leaf count."""
    nodes = twb.nodes.numpy().reshape(-1, WIDE, 8)
    tri = tpb.tri.numpy()
    n_rows = int((tpb.nodes[:, 7]).sum())
    seen = np.zeros(n_rows, np.int64)
    parents = np.zeros(len(nodes), np.int64)
    first_row = np.full(len(nodes), np.iinfo(np.int64).max)

    def rows_of(w):  # the least row below node w
        out = []
        for lo_hi_first_count in nodes[w]:
            f, c = int(lo_hi_first_count[6]), int(lo_hi_first_count[7])
            out.append(f if c > 0 else rows_of(f) if c == 0 else None)
        return min(r for r in out if r is not None)

    for w in range(len(nodes) - 1, -1, -1):
        prev = -1
        for slot in nodes[w]:
            lo, hi, f, c = slot[0:3], slot[3:6], int(slot[6]), int(slot[7])
            if c < 0:
                continue
            if c > 0:
                assert c <= tisect.PACKET_LEAF
                seen[f: f + c] += 1
                r = tri[f: f + c]
                for v in (r[:, 0:3], r[:, 0:3] + r[:, 3:6],
                          r[:, 0:3] + r[:, 6:9]):
                    assert (v >= lo - 1e-6).all() and (v <= hi + 1e-6).all()
                low = f
            else:
                assert w < f < len(nodes)
                parents[f] += 1
                kids = nodes[f][nodes[f][:, 7] >= 0]
                assert (kids[:, 0:3] >= lo).all()
                assert (kids[:, 3:6] <= hi).all()
                low = rows_of(f)
            assert low > prev
            prev = low
    assert (seen == 1).all()
    assert parents[0] == 0 and (parents[1:] == 1).all()
    faces = np.sort(tri[:n_rows, 9].astype(np.int64))
    np.testing.assert_array_equal(faces, np.arange(n_rows))
    return n_rows


@pytest.mark.parametrize("name", ["sphere4", "spheres", "twins"])
def test_wide_bvh_invariants(tables, name):
    p, _, tpb, twb = tables[name]
    assert twb.nodes.dtype == torch.float32
    assert twb.nodes.shape[1] == 8 * WIDE and twb.tri is tpb.tri
    assert _wide_invariants(twb, tpb) == len(p[0])
    # wide: the nodes hold ~3 children on average, and far fewer nodes than
    # the PacketBVH's
    slots = int((twb.nodes[:, 7::8] >= 0).sum())
    assert slots == len(twb.nodes) - 1 + int((tpb.nodes[:, 7] > 0).sum())
    assert len(twb.nodes) < len(tpb.nodes) // 2
    assert 1 <= twb.stack <= tisect.WIDE_STACK_MAX


def test_wide_bvh_of_the_packet_scene(packet_scenes):
    """The scene's WideBVH is built from its PacketBVH, rebuilt with it,
    and holds the icosphere's faces once each."""
    _, ts = packet_scenes
    assert ts.wbvh.tri is ts.pbvh.tri
    assert _wide_invariants(ts.wbvh, ts.pbvh) == ts.geo.n_faces
    other = pack_packet_bvh(*bi.soup_bvh(ts), device="cpu")
    swapped = dataclasses.replace(ts, pbvh=other)
    assert swapped.wbvh.tri is other.tri
    # a one-leaf PacketBVH gives a root with that one child
    p = [x[:5] for x in _sphere4()]
    small = pack_packet_bvh(build_bvh(*_mesh_of(p)), *p, device="cpu")
    wb = pack_wide_bvh(small)
    assert wb.nodes.shape[0] == 1 and wb.stack == 1
    assert int((wb.nodes[0, 7::8] >= 0).sum()) == 1
    o, d = _rays(64, seed=4)
    t, prim, _, _ = tisect.intersect_bvh(wb, *_t(o, d, np.full(
        64, np.inf, np.float32)))
    assert ((prim >= 0) == torch.isfinite(t)).all()


@pytest.mark.parametrize("name", ["sphere4", "spheres", "twins"])
def test_wide_walk_matches_skip_link_walk(tables, name):
    """The closest hit over the WideBVH against the skip-link walk it
    replaced, on the same rays, maxt inf and finite: the least (t, row)
    with near <= best gates is the skip-link walk's first hit in row order
    with near < best gates, so prim, t, u and v agree on every lane here
    (a box culled by rounding could part them on a rare lane); the stack
    never outgrows the table's bound."""
    _, _, tpb, twb = tables[name]
    n = 4096
    o, d = _rays(n, seed=7)
    if name == "spheres":
        o[:, 0] *= 2.0
    rng = np.random.default_rng(3)
    mt = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 4.0, n),
                  np.inf).astype(np.float32)
    counts = {}
    t, prim, u, v = tisect.intersect_bvh_plain(twb, *_t(o, d, mt),
                                               counts=counts)
    ot, oprim, ou, ov, _ = tisect._bvh_walk(tpb, *_t(o, d, mt), False, None)
    oprim = oprim.to(torch.int32)
    assert torch.equal(prim, oprim)
    assert torch.equal(t, torch.where(oprim >= 0, ot, float("inf")))
    assert torch.equal(u, ou) and torch.equal(v, ov)
    assert 0.2 < (prim >= 0).float().mean() < 0.9
    assert 0 < counts["stack_peak"] <= twb.stack
    assert counts["steps"] == int(counts["ray_pops"].max())
    assert counts["triangle_tests"] == int(counts["ray_triangle_tests"].sum())


@pytest.mark.parametrize("name", ["sphere4", "spheres", "twins"])
def test_intersect_bvh_plain_matches_jax_kernel(tables, name):
    _, jpb, _, twb = tables[name]
    o, d = _rays(1024, seed=len(name))
    if name == "spheres":
        o[:, 0] *= 2.0  # spread the origins over the three spheres
    mt = np.full(1024, np.inf, np.float32)
    jt, jp, ju, jv = map(np.asarray, pallas_bvh_intersect(
        jpb, *_j(o, d, mt), interpret=True))
    t, p, u, v = (x.numpy() for x in tisect.intersect_bvh(twb, *_t(o, d, mt)))
    assert p.dtype == np.int32
    # the tolerances of tests/test_bvh_pallas.py: equal hit masks, prim
    # equal or tied, t at rtol 1e-4 / atol 1e-5, u and v at rtol 1e-3 /
    # atol 1e-4
    hit = p >= 0
    np.testing.assert_array_equal(hit, jp >= 0)
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-4, atol=1e-5)
    same = p == jp
    assert np.all(same | np.isclose(t, jt, rtol=1e-4, atol=1e-5))
    # ties included, the first triangle in leaf order wins in both
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-3, atol=1e-4)
    assert np.all(np.isinf(t[~hit])) and np.all(u[~hit] == 0)


def test_intersect_bvh_plain_matches_oracle_and_clu2(tables):
    """Per-ray gating against the brute-force oracle of the JAX package and
    against the port's clu2 walk on the same mesh: 1,024 rays with equal hit
    masks (the JAX test's demand of its kernel), and 8,192 rays on which the
    share of lanes that differ is stated."""
    p, _, _, twb = tables["sphere4"]
    verts, faces = _mesh_of(p)
    ct = pack_clusters2(build_bvh(verts, faces), *p, device="cpu")
    for n, seed in ((1024, 0), (8192, 5)):
        o, d = _rays(n, seed)
        mt = np.full(n, np.inf, np.float32)
        rt, rp, ru, _ = map(np.asarray, brute_force_intersect(
            *_j(*p), *_j(o, d, mt)))
        t, prim, u, _ = (x.numpy() for x in tisect.intersect_bvh_plain(
            twb, *_t(o, d, mt)))
        ct_t, ct_p, _, _ = (x.numpy() for x in tisect.intersect_clu2_plain(
            ct, *_t(o, d, mt)))
        hit = prim >= 0
        differ = (hit != (rp >= 0)).mean()
        print(f"{n} rays: hit mask differs from the oracle on {differ:.6f}, "
              f"from clu2 on {(hit != (ct_p >= 0)).mean():.6f} of lanes")
        # measured: 0 of 1,024 and 0 of 8,192 lanes differ
        assert differ == 0.0
        np.testing.assert_array_equal(hit, ct_p >= 0)
        np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t[hit], ct_t[hit], rtol=1e-4, atol=1e-5)
        same = prim == rp
        assert np.all(same | np.isclose(t, rt, rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(u[same & hit], ru[same & hit],
                                   rtol=1e-3, atol=1e-4)
        assert (prim == ct_p).mean() >= 0.999


def test_bvh_maxt(tables):
    """Segments that end before the sphere miss; an infinite maxt is carried
    as a finite bound and a miss returns t = inf, prim = -1."""
    _, jpb, tpb, twb = tables["sphere4"]
    o, d = _rays(256, seed=1)
    mt = np.full(256, 0.5, np.float32)  # the surface is >= 2 from |o| = 3
    t, prim, u, v = tisect.intersect_bvh(twb, *_t(o, d, mt))
    assert (prim == -1).all() and torch.isinf(t).all()
    assert (u == 0).all() and (v == 0).all()
    assert not tisect.occluded_bvh(twb, *_t(o, d, mt)).any()
    assert not tisect._bvh_walk(tpb, *_t(o, d, mt), True, None)[4].any()
    jp = np.asarray(pallas_bvh_intersect(jpb, *_j(o, d, mt),
                                         interpret=True)[1])
    assert (jp == -1).all()


@pytest.mark.parametrize("name", ["sphere4", "spheres"])
def test_occluded_bvh_plain_matches_jax_kernel(tables, name):
    _, jpb, tpb, twb = tables[name]
    o, d = _rays(1024, seed=2)
    t0 = tisect.intersect_bvh(twb, *_t(o, d, np.full(1024, np.inf,
                                                      np.float32)))[0].numpy()
    rng = np.random.default_rng(11)
    # segments ending just short of / past the closest hit, random ones,
    # infinite and empty ones
    frac = rng.choice([0.95, 1.05], 1024)
    mt = np.where(np.isfinite(t0), t0 * frac, rng.uniform(0, 9, 1024))
    mt[::13] = np.inf
    mt[5::17] = 0.0
    mt = mt.astype(np.float32)
    want = np.asarray(pallas_bvh_occluded(jpb, *_j(o, d, mt),
                                          interpret=True))
    counts, full, skip = {}, {}, {}
    got = tisect.occluded_bvh_plain(twb, *_t(o, d, mt), counts=counts).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < got.mean() < 0.9
    # the skip-link walk over the PacketBVH, to the bit
    np.testing.assert_array_equal(
        tisect._bvh_walk(tpb, *_t(o, d, mt), True, skip)[4].numpy(), want)
    # an any-hit walk stops at the first hit: fewer tests than the same
    # walk to the closest hit, over either table
    tisect.intersect_bvh_plain(twb, *_t(o, d, mt), counts=full)
    assert 0 < counts["triangle_tests"] < full["triangle_tests"]
    assert 0 < counts["stack_peak"] <= twb.stack
    skip_full = {}
    tisect._bvh_walk(tpb, *_t(o, d, mt), False, skip_full)
    assert 0 < skip["triangle_tests"] < skip_full["triangle_tests"]
    assert 1024 <= skip["slab_tests"] < skip_full["slab_tests"]


def test_bvh_dead_lane_convention(tables):
    """The canonical dead ray (o = 1e8, d = +z) fails the root's slab test
    of the skip-link walk (one box test per lane, no triangle test) and the
    slab tests of the WideBVH root's children in both wide walks (one pop
    per lane, no triangle test)."""
    _, _, tpb, twb = tables["sphere4"]
    n = 256
    o = torch.full((n, 3), 1e8)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    counts, wide, skip = {}, {}, {}
    occ = tisect._bvh_walk(tpb, o, d, torch.full((n,), 1e30), True,
                           skip)[4]
    assert not occ.any()
    assert skip == {"slab_tests": n, "triangle_tests": 0, "steps": 1}
    root = int((twb.nodes[0, 7::8] >= 0).sum())
    one_pop = {"slab_tests": n * root, "triangle_tests": 0, "steps": 1,
               "stack_peak": 0}
    for mt in (torch.full((n,), 1e30), torch.zeros(n)):
        counts = {}
        assert not tisect.occluded_bvh_plain(twb, o, d, mt,
                                             counts=counts).any()
        assert {k: counts[k] for k in one_pop} == one_pop
        assert (counts["ray_pops"] == 1).all()
        assert (counts["ray_triangle_tests"] == 0).all()
    t, p, _, _ = tisect.intersect_bvh_plain(
        twb, o, d, torch.full((n,), float("inf")), counts=wide)
    assert (p == -1).all() and torch.isinf(t).all()
    assert {k: wide[k] for k in one_pop} == one_pop
    assert (wide["ray_pops"] == 1).all()
    assert not tisect.occluded_bvh(twb, o, d, torch.zeros(n)).any()


def test_bvh_wrappers_check_arguments(tables):
    _, _, tpb, twb = tables["sphere4"]
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(TypeError):
        tisect.intersect_bvh(twb, o.double(), d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_bvh(twb, o, d[:4], mt)
    with pytest.raises(ValueError):
        tisect.intersect_bvh(
            dataclasses.replace(twb, tri=twb.tri[:, :8].contiguous()),
            o, d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_bvh(
            dataclasses.replace(twb, nodes=twb.nodes[:0]), o, d, mt)
    # a PacketBVH is not the table of either walk, and the stack must fit
    for fn in (tisect.intersect_bvh, tisect.occluded_bvh):
        with pytest.raises(ValueError):
            fn(tpb, o, d, mt)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(twb, stack=tisect.WIDE_STACK_MAX + 1),
               o, d, mt)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(twb, stack=0), o, d, mt)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(twb, tri=twb.tri[:, :9].contiguous()),
               o, d, mt)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(twb, nodes=twb.nodes[:, :32].contiguous()),
               o, d, mt)
        with pytest.raises(TypeError):
            fn(twb, o, d, mt.double())


def _mixed_rays(scene, seed):
    """Camera rays, rays between random points around the sphere, and dead
    lanes, in one wavefront."""
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays

    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(seed, W * H, device="cpu"),
                         W, H, 1)
    rng = np.random.default_rng(seed)
    n = W * H
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o[::7] = 1e8
    d[::7] = (0.0, 0.0, 1.0)
    return (np.concatenate([cam.o.numpy(), o]),
            np.concatenate([cam.d.numpy(), d]))


@pytest.fixture(scope="module")
def packet_scenes():
    """(JAX mesh scene with a PacketBVH in place of its treelet tables, the
    way the JAX package's tools build it; the port's packet preset)."""
    js = jax_mesh_scene(16, 16, 5)
    g = js.geo
    jpb = j_pack_packet_bvh(js.bvh, g.tri_p0, g.tri_p1, g.tri_p2)
    js = dataclasses.replace(js, ctab2=None, pbvh=jpb)
    return js, tpresets.mesh_scene(16, 16, 5, accel="packet", device="cpu")


def test_packet_perm_matches_jax(packet_scenes):
    js, ts = packet_scenes
    o, d = _mixed_rays(ts, seed=3)
    jperm, jinv = map(np.asarray, js._packet_perm(*_j(o, d)))
    perm, inv = ts._packet_perm(*_t(o, d))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(len(o)))
    # it is a sort: many lanes move
    assert (perm.numpy() != np.arange(len(o))).mean() > 0.5


def test_bridge_takes_pbvh_leaves(packet_scenes):
    js, port = packet_scenes
    arrays, static = jax_scene_arrays(js)
    assert "pbvh.nodes" in arrays and "ctab2.rows" not in arrays
    bridged = scene_from_arrays(arrays, static, device="cpu")
    assert bridged.ctab2 is None and port.ctab2 is None
    for field in ("nodes", "tri"):
        got = getattr(port.pbvh, field)
        np.testing.assert_array_equal(got.numpy(), arrays["pbvh." + field])
        np.testing.assert_array_equal(
            got.numpy(), getattr(bridged.pbvh, field).numpy())
    # a big mesh with neither table is refused
    bare = {k: v for k, v in arrays.items() if not k.startswith("pbvh.")}
    with pytest.raises(NotImplementedError, match="ctab2"):
        scene_from_arrays(bare, static, device="cpu")
    with pytest.raises(ValueError, match="accel"):
        tpresets.mesh_scene_arrays(8, 8, 5, accel="bvh")


def test_packet_route_sorts_and_unsorts(packet_scenes):
    """The route's output is that of the unsorted call (rays are
    independent), and the scene's other records follow from it."""
    _, ts = packet_scenes
    assert ts.intersect_route() == "packet"
    clu2 = tpresets.mesh_scene(16, 16, 5, device="cpu")
    assert clu2.intersect_route() == "clu2" and clu2.pbvh is None
    o, d = _mixed_rays(ts, seed=4)
    ray = Ray.create(*_t(o, d))
    ops.reset_launch_counts()
    si = ts.ray_intersect(ray)
    t, prim, _, _ = tisect.intersect_bvh(ts.wbvh, ray.o, ray.d, ray.maxt)
    np.testing.assert_array_equal(si.prim_idx.numpy(), prim.numpy())
    np.testing.assert_array_equal(si.t.numpy(), t.numpy())
    assert 0.2 < si.valid.float().mean() < 0.9
    si2 = clu2.ray_intersect(ray)
    assert (si.prim_idx == si2.prim_idx).float().mean() >= 0.999
    np.testing.assert_array_equal(si.valid.numpy(), si2.valid.numpy())
    mt = torch.where(si.valid, si.t * 1.05, 2.0)
    mt[::3] = 0.5
    sray = Ray(o=ray.o, d=ray.d, maxt=mt)
    occ = ts.ray_test(sray)
    np.testing.assert_array_equal(
        occ.numpy(),
        tisect.occluded_bvh(ts.wbvh, sray.o, sray.d, sray.maxt).numpy())
    np.testing.assert_array_equal(occ.numpy(), tisect._bvh_walk(
        ts.pbvh, sray.o, sray.d, sray.maxt, True, None)[4].numpy())
    np.testing.assert_array_equal(occ.numpy(), clu2.ray_test(sray).numpy())
    assert 0.1 < occ.float().mean() < 0.9
    # on the CPU the plain versions ran: no launch is counted
    assert ops.launch_counts()["intersect_bvh"] == 0
    assert ops.launch_counts()["occluded_bvh"] == 0


def test_packet_entry_points_need_a_card_unless_asked_for_the_cpu(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpresets.mesh_scene(8, 8, 2, accel="packet")
    p, _, _, _ = tables["sphere4"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_packet_bvh(build_bvh(*_mesh_of(p)), *p)
