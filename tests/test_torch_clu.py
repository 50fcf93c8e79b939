"""The flat treelet tables and kernels (B10) of the port against the JAX
package on the CPU: `pack_clusters` leaf for leaf, the plain closest and
any hit against `pallas_intersect_clu` / `pallas_occluded_clu` in
interpret mode, the per-lane gate against the brute force, and the
cluster-mask sort tool (`tools/isect_mask_sort.py`): its key against a
numpy statement of the JAX tool's, and its sorted and Morton pipelines
against the unsorted call on every lane."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pallas_intersect_clu, pallas_occluded_clu,
)
from mitsuba3_plt_tpu.scene.bvh import build_bvh as j_build_bvh
from mitsuba3_plt_tpu.scene.bvh import pack_clusters as j_pack_clusters
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene.bvh import (
    ClusterTable, build_bvh, pack_clusters, pack_clusters_arrays,
)
from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
from test_torch_brute import _check_closest

N_RAYS = 768  # the JAX cluster tests' ray count
CT_FIELDS = ("boxes", "rows", "anchor")


def _spheres():
    """(p0, p1, p2) of tests/test_isect_clu.py's scene: three 320-face
    spheres at x = -2.5, 0, 2.5 and a ground plane at y = -1.5 scaled by
    6 (1,282 faces)."""
    parts = []
    for cx in (-2.5, 0.0, 2.5):
        m = tshape.make_sphere(subdiv=2)
        parts.append((m.vertices + np.array([cx, 0.0, 0.0], np.float32),
                      m.faces))
    pv, pf, _, _ = tshape.make_rectangle(np.eye(4, dtype=np.float32))
    pv = pv * 6.0
    pv[:, 1] -= 1.5
    parts.append((pv, pf))
    return [np.concatenate([v[f[:, c]] for v, f in parts]).astype(np.float32)
            for c in range(3)]


def _cbox_soup():
    g = tpresets.cornell_box(8, 8, device="cpu").geo
    rows = g.tri_isect[: g.n_faces].numpy()
    return [rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
            rows[:, 0:3] + rows[:, 6:9]]


def _mesh_of(p):
    nf = len(p[0])
    faces = np.stack([np.arange(nf), np.arange(nf) + nf,
                      np.arange(nf) + 2 * nf], -1).astype(np.int32)
    return np.concatenate(p, 0), faces


@pytest.fixture(scope="module")
def soups():
    return {"spheres": _spheres(), "cbox": _cbox_soup()}


@pytest.fixture(scope="module")
def spheres(soups):
    """(JAX ClusterTable, the port's) of the spheres at max_leaf 64."""
    p = soups["spheres"]
    verts, faces = _mesh_of(p)
    return (j_pack_clusters(j_build_bvh(verts, faces), *p),
            pack_clusters(build_bvh(verts, faces), *p, device="cpu"))


def _rays(n, seed):
    """tests/test_isect_clu.py's rays: origins around z = -5 aimed
    forward."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=1.5, size=(n, 3)).astype(np.float32)
    o[:, 2] -= 5.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _maxt(kind):
    return np.full(N_RAYS, np.inf if kind == "inf" else 4.0, np.float32)


@pytest.mark.parametrize("name,max_leaf", [("spheres", 64),
                                           ("spheres", 128), ("cbox", 64),
                                           ("cbox", 128)])
def test_pack_clusters_matches_jax(soups, name, max_leaf):
    p = soups[name]
    verts, faces = _mesh_of(p)
    want = j_pack_clusters(j_build_bvh(verts, faces), *p, max_leaf=max_leaf)
    got = pack_clusters_arrays(build_bvh(verts, faces), *p, max_leaf)
    for field in CT_FIELDS:
        assert got[field].dtype == np.float32, field
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    n_real = int((got["boxes"][:, 7] > 0).sum())
    if name == "cbox":  # 36 faces: one cluster, padded to 8 boxes
        assert n_real == 1 and got["boxes"].shape == (8, 16)
    else:
        assert n_real > 4 and got["rows"].shape[1] == 32


@pytest.mark.parametrize("mt_kind", ["inf", "4.0"])
def test_intersect_clu_plain_matches_jax_kernel(spheres, mt_kind):
    jct, tct = spheres
    o, d = _rays(N_RAYS, seed=0)
    mt = _maxt(mt_kind)
    want = tuple(map(np.asarray, pallas_intersect_clu(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True)))
    got = tuple(x.numpy() for x in tisect.intersect_clu(
        tct, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mt)))
    assert got[1].dtype == np.int32
    # t at rtol 1e-5, u and v at atol 1e-5; another prim only where
    # rounding decides (XLA contracts the Pallas multiply-adds into FMAs)
    _check_closest(got, want)
    hit = got[1] >= 0
    assert 0.05 < hit.mean() < 0.95
    assert np.all(got[2][~hit] == 0) and np.all(got[3][~hit] == 0)


def _sequential_walk(ctab, o, d, maxt):
    """The closest-hit kernel's update (ops/csrc/intersect_clu.cu,
    clu_closest_kernel) written out over all lanes: each box gated in table
    order on the lane's best as it stands there, and the strict
    cross-multiplied compare applied to an entered cluster's inside rows one
    by one in row order, which is what the kernel's lane-a-ray rows and its
    tiles' in-step updates both do. The best keeps its row; the face index
    is read at the end."""
    walk = tisect._CluWalk(ctab, o, d, maxt, None)
    ts_b = walk.mt.clone()
    ad_b = torch.ones_like(ts_b)
    us_b = torch.zeros_like(ts_b)
    vs_b = torch.zeros_like(ts_b)
    k_b = torch.full(ts_b.shape, -1, dtype=torch.int64)
    for c in range(ctab.boxes.shape[0]):
        first, rows = walk.spans[c]
        near, far = walk.slab(ctab.boxes[c], walk.o, walk.inv)
        enter = (near <= far) & (far > 0.0) & (near * ad_b < ts_b)
        if not rows or not enter.any():
            continue
        lanes = enter.nonzero().squeeze(1)
        (ad, us, vs, ts, inside), _ = walk.triangles(lanes, c)
        for q in range(rows):
            take = inside[:, q] & (
                ts[:, q] * ad_b[lanes] < ts_b[lanes] * ad[:, q])
            sel = lanes[take]
            for dst, src in ((ts_b, ts), (ad_b, ad), (us_b, us),
                             (vs_b, vs)):
                dst[sel] = src[take, q]
            k_b[sel] = first + q
    prim = torch.where(k_b >= 0, ctab.rows[k_b.clamp(min=0), 16],
                       -1.0).to(torch.int32)
    inv = 1.0 / ad_b
    return (torch.where(prim >= 0, ts_b * inv, float("inf")), prim,
            us_b * inv, vs_b * inv)


@pytest.mark.parametrize("case", ["cbox-ctab64", "cbox-ctab128",
                                  "spheres-inf", "spheres-4.0"])
def test_intersect_clu_plain_matches_sequential_walk(spheres, cbox, case):
    """The plain closest hit (nearest candidate by division, ties by the
    sequential compare) equals the sequential strict cross-multiplied
    update in row order, to the bit: on the Cornell box's incoherent rays,
    whose origins lie inside its boxes, where the box bottoms and the floor
    are coplanar and tie exactly (each table), and on the spheres' rays
    (maxt inf and finite)."""
    name, arg = case.split("-", 1)
    if name == "cbox":
        tab = ms.tables(cbox)[arg]
        o, d, mt = bi.ray_sets(cbox, 4096, 3)["incoherent"]
    else:
        tab = spheres[1]
        o, d = (torch.as_tensor(x) for x in _rays(N_RAYS, seed=4))
        mt = torch.as_tensor(_maxt(arg))
    want = tisect.intersect_clu_plain(tab, o, d, mt)
    got = _sequential_walk(tab, o, d, mt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0.05 < (want[1] >= 0).float().mean()


@pytest.mark.parametrize("mt_kind", ["inf", "4.0"])
def test_occluded_clu_plain_matches_jax_kernel(spheres, mt_kind):
    jct, tct = spheres
    o, d = _rays(N_RAYS, seed=1)
    mt = _maxt(mt_kind)
    want = np.asarray(pallas_occluded_clu(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True))
    counts = {}
    ot, dt, mtt = (torch.as_tensor(x) for x in (o, d, mt))
    got = tisect.occluded_clu_plain(tct, ot, dt, mtt, counts=counts).numpy()
    assert (got == want).mean() >= 0.999
    # where the flags differ, rounding decides: the closest hit lies
    # within 1e-4 of maxt or on a triangle's boundary
    t, _, u, v = (x.numpy() for x in tisect.intersect_clu_plain(
        tct, ot, dt, torch.full_like(mtt, float("inf"))))
    off = got != want
    near_end = np.abs(t[off] - mt[off]) <= 1e-4 * mt[off]
    edge = np.minimum(np.minimum(u[off], v[off]), 1 - u[off] - v[off]) < 1e-4
    assert (near_end | edge).all()
    assert 0.05 < got.mean() < 0.95
    assert counts["cluster_tests"] == N_RAYS * tct.boxes.shape[0]
    assert 0 < counts["triangle_tests"] < N_RAYS * tct.rows.shape[0]


def _tile_split_walk(ctab, o, d, maxt, warp=32, tile=8, tile_rays=8):
    """The any-hit kernel's walk (ops/csrc/intersect_clu.cu,
    clu_anyhit_kernel) written out over warps of `warp` consecutive lanes:
    each box gated in table order per lane (slab test, near < maxt, not yet
    occluded); a cluster that more than `tile_rays` lanes of a warp enter
    runs its rows a lane a ray, in row order; else each entrant's tile
    tests the rows a step of `tile` at a time (one a lane) and stops at its
    first step with a hit. Returns (occ, {"lane", "tile": the (warp,
    cluster) pairs run each way})."""
    walk = tisect._CluWalk(ctab, o, d, maxt, None)
    n = walk.mt.shape[0]
    occ = torch.zeros(n, dtype=torch.bool)
    modes = {"lane": 0, "tile": 0}
    for c in range(ctab.boxes.shape[0]):
        rows = walk.spans[c][1]
        near, far = walk.slab(ctab.boxes[c], walk.o, walk.inv)
        enter = (near <= far) & (far > 0.0) & (near < walk.mt) & ~occ
        if not rows or not enter.any():
            continue
        lanes = enter.nonzero().squeeze(1)
        (ad, _, _, ts, inside), _ = walk.triangles(lanes, c)
        hit = inside & (ts < walk.mt[lanes, None] * ad)
        warps = lanes // warp
        entrants = torch.bincount(warps)[warps]
        tiled = entrants <= tile_rays
        for key, sel in (("tile", tiled), ("lane", ~tiled)):
            modes[key] += int(torch.unique(warps[sel]).numel())
        steps = hit.reshape(len(lanes), rows // tile, tile).any(2)
        # the step at which each tile stops: its first with a hit
        stop = torch.where(steps.any(1), steps.to(torch.int8).argmax(1),
                           rows // tile)
        occ[lanes] = torch.where(tiled, stop < rows // tile, hit.any(1))
    return occ, modes


@pytest.mark.parametrize("case", ["cbox-ctab64", "cbox-ctab128",
                                  "spheres-inf", "spheres-4.0"])
def test_occluded_clu_plain_matches_a_tile_split_walk(spheres, cbox, case):
    """The any hit is an OR over a cluster's rows, which its kernel relies
    on when a cluster that few lanes of a warp enter runs a tile of lanes a
    ray (`_tile_split_walk`): the plain walk gives the same answer, on the
    Cornell box's shadow rays (its one cluster; lanes killed by roulette
    leave some warps few entrants) and incoherent rays with maxt 1, and on
    the spheres' rays (maxt inf and finite); both modes occur."""
    name, arg = case.split("-", 1)
    if name == "cbox":
        tab = ms.tables(cbox)[arg]
        sets = ms.ray_sets(cbox, 1, seed=6)
        o, d, mt = (torch.cat(x) for x in zip(sets["shadow0"],
                                               sets["shadow2"]))
        inc = bi.ray_sets(cbox, 2048, 6)["incoherent"]
        o, d = torch.cat([o, inc[0]]), torch.cat([d, inc[1]])
        mt = torch.cat([mt, torch.ones(2048)])
    else:
        tab = spheres[1]
        o, d = (torch.as_tensor(x) for x in _rays(N_RAYS, seed=8))
        mt = torch.as_tensor(_maxt(arg))
    want = tisect.occluded_clu_plain(tab, o, d, mt)
    got, modes = _tile_split_walk(tab, o, d, mt)
    assert torch.equal(got, want)
    assert 0.02 < want.float().mean() < 0.98
    assert modes["tile"] > 0 and modes["lane"] > 0, modes


def test_clu_gate_is_conservative(spheres):
    """The per-lane box gate drops no hit: the plain walk equals the brute
    force over the same q rows (in cluster order) on every lane."""
    _, tct = spheres
    o, d = (torch.as_tensor(x) for x in _rays(N_RAYS, seed=2))
    mt = torch.full((N_RAYS,), float("inf"))
    mt[::5] = 4.0
    counts = {}
    got = tisect.intersect_clu_plain(tct, o, d, mt, counts=counts)
    want = tisect.intersect_q_plain(tct.rows[:, :16].contiguous(),
                                     tct.anchor, o, d, mt)
    prim = torch.where(want[1] >= 0, tct.rows[want[1].clamp_min(0).long(),
                                              16].to(torch.int32), -1)
    assert torch.equal(got[1], prim)
    for k in (0, 2, 3):
        assert torch.equal(got[k], want[k])
    assert counts["triangle_tests"] < N_RAYS * tct.rows.shape[0] / 2
    occ = tisect.occluded_clu_plain(tct, o, d, mt)
    assert torch.equal(occ, tisect.occluded_q_plain(
        tct.rows[:, :16].contiguous(), tct.anchor, o, d, mt))


def test_clu_wrappers_check_arguments(spheres):
    import dataclasses

    _, tct = spheres
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(TypeError):
        tisect.intersect_clu(tct, o.double(), d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_clu(tct, o, d[:4], mt)
    with pytest.raises(ValueError):
        tisect.intersect_clu(
            dataclasses.replace(tct, rows=tct.rows[:, :16].contiguous()),
            o, d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_clu(dataclasses.replace(tct, anchor=torch.zeros(4)),
                            o, d, mt)
    # the canonical dead ray (o = 1e8, d = +z) misses everything
    dead = torch.full((4, 3), 1e8)
    up = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    t, p, u, v = tisect.intersect_clu(tct, dead, up, torch.ones(4))
    assert (p == -1).all() and torch.isinf(t).all()
    assert not tisect.occluded_clu(tct, dead, up, torch.ones(4)).any()
    assert isinstance(tct, ClusterTable)


def _mask_numpy(boxes, anchor, o, d, maxt):
    """isect_mask_sort.py:48-77 in numpy uint32."""
    K = boxes.shape[0]
    o = o - anchor[None, :]
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    d_safe = np.where(np.abs(d) > 1e-12, d,
                      np.where(d >= 0, 1e-12, -1e-12)).astype(np.float32)
    inv = np.float32(1.0) / d_safe
    with np.errstate(over="ignore"):
        t0 = (lo[None] - o[:, None]) * inv[:, None]
        t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = np.minimum(t0, t1).max(-1)
    far = np.maximum(t0, t1).min(-1)
    mt = np.where(np.isfinite(maxt), maxt, np.float32(3.4e38))
    hit = (near <= far) & (far > 0.0) & (near < mt[:, None])
    if K <= 32:
        bits = np.uint32(1) << np.arange(K, dtype=np.uint32)
        return np.sum(np.where(hit, bits[None], np.uint32(0)), axis=-1,
                      dtype=np.uint32)
    idx = np.arange(K, dtype=np.uint32)
    first = np.min(np.where(hit, idx[None], np.uint32(K)), axis=-1)
    with np.errstate(over="ignore"):
        w = (idx * np.uint32(2654435761)) ^ (idx << np.uint32(7))
    h = np.sum(np.where(hit, w[None], np.uint32(0)), axis=-1,
               dtype=np.uint32)
    return (first << np.uint32(24)) | (h & np.uint32(0xFFFFFF))


@pytest.fixture(scope="module")
def cbox():
    return tpresets.cornell_box(16, 16, device="cpu")


@pytest.mark.parametrize("name", ["cbox", "spheres"])
def test_cluster_mask_matches_numpy(spheres, cbox, name, monkeypatch):
    """K <= 32 (the Cornell box: one cluster padded to 8 boxes) and K > 32
    (the spheres' table at max_leaf 16), over several chunks."""
    if name == "cbox":
        # shadow rays: the dead lanes (o = 1e8) enter no real box
        ctab = ms.tables(cbox)["ctab64"]
        o, d, mt = ms.ray_sets(cbox, 2)["shadow1"]
    else:
        p = _spheres()
        ctab = pack_clusters(build_bvh(*_mesh_of(p)), *p, max_leaf=16,
                             device="cpu")
        o, d = (torch.as_tensor(x) for x in _rays(N_RAYS, seed=3))
        mt = torch.full((N_RAYS,), float("inf"))
        mt[::4] = 3.0
    K = ctab.boxes.shape[0]
    assert (K <= 32) == (name == "cbox")
    monkeypatch.setattr(ms, "MASK_ELEMS", 100 * K)
    got = ms.cluster_mask(ctab, o, d, mt)
    want = _mask_numpy(ctab.boxes.numpy(), ctab.anchor.numpy(), o.numpy(),
                       d.numpy(), mt.numpy())
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(np.unique(want)) > 1


def test_mask_sort_tool_runs_on_the_cpu(cbox):
    """The tool's routes on the Cornell box's sets: every sorted and
    Morton pipeline equals the unsorted cluster call on every lane, every
    route agrees with q on >= 99% of lanes and hits at q's distance on
    every lane, no kernel launches on the CPU, and with a timer each route
    is timed once per set."""
    sets = ms.ray_sets(cbox, 2, seed=1)
    assert set(sets) == {"incoherent", "depth0", "depth1", "depth2",
                         "depth3", "shadow0", "shadow1", "shadow2",
                         "shadow3"}
    assert sets["incoherent"][0].shape == (512, 3)
    # about 15% of each bounce's live lanes die: fewer live lanes each depth
    live = [int((sets[f"depth{k}"][0][:, 0] < 1e7).sum()) for k in range(4)]
    assert live[0] == 512 and live[1] > live[2] > live[3]
    fns = ms.route_fns(cbox)
    for label, (o, d, mt) in sets.items():
        any_hit = label.startswith("shadow")
        base = fns["clu"][any_hit](o, d, mt)
        for name in ("m64", "m128", "clu-morton"):
            got = fns[name][any_hit](o, d, mt)
            if any_hit:
                assert torch.equal(got, base), (label, name)
            else:
                assert all(torch.equal(a, b) for a, b in zip(got, base)), \
                    (label, name)
    ops.reset_launch_counts()
    rows = ms.run(cbox, sets)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert len(rows) == 9 * len(ms.ROUTES)
    for r in rows:
        assert r["ms"] is None and r["n"] == 512
        assert r["occ_agree" if r["kind"] == "any hit"
                 else "prim_agree"] >= 0.99, r
        # another prim only at the same distance: coplanar faces tie, and
        # the cluster table orders faces otherwise than the q table
        assert r["kind"] == "any hit" or r["same_hit"] == 1.0, r
    calls = []
    timed = ms.run(cbox, {"depth1": sets["depth1"]}, routes=("q", "m64"),
                   timer=lambda fn: calls.append(fn()) or 2.0)
    assert [r["route"] for r in timed] == ["q", "m64"] and len(calls) == 2
    assert timed[1]["ms_per_mrays"] == 2.0 / (512 / 1e6)
    assert timed[1]["boxes"] == 8


def test_mask_sort_pipelines_on_a_mesh(spheres):
    """On the spheres' table (K > 32, the hash key) the sorted and Morton
    pipelines equal the unsorted call on every lane."""
    _, tct = spheres
    o, d = (torch.as_tensor(x) for x in _rays(N_RAYS, seed=4))
    mt = torch.full((N_RAYS,), 6.0)
    scene = tpresets.mesh_scene(8, 8, subdiv=1, device="cpu")
    packet = bi.packet_scene(scene)
    for any_hit in (False, True):
        base = (tisect.occluded_clu if any_hit
                else tisect.intersect_clu)(tct, o, d, mt)
        for fn in (ms.sorted_pipeline(tct, any_hit),
                   ms.morton_pipeline(packet, tct, any_hit)):
            got = fn(o, d, mt)
            if any_hit:
                assert torch.equal(got, base)
            else:
                assert all(torch.equal(a, b) for a, b in zip(got, base))


def test_cbox_ray_sets_kill_and_light(cbox):
    """The defaults keep the intersection tool's sets; `kill` and `light`
    change only what they name."""
    a = bi.cbox_ray_sets(cbox, 2, 5)
    b = bi.cbox_ray_sets(cbox, 2, 5, kill=0.0, light=bi.CBOX_LIGHT)
    for k in a:
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
    c = bi.cbox_ray_sets(cbox, 2, 5, light=(0.0, 0.5, 0.0))
    assert all(torch.equal(x, y) for x, y in zip(a["depth3"], c["depth3"]))
    assert not torch.equal(a["shadow0"][1], c["shadow0"][1])
    mesh = tpresets.mesh_scene(8, 8, subdiv=1, device="cpu")
    assert ms.scene_light(mesh) == (2.0, 2.0, 3.0)
    assert ms.scene_light(cbox) == bi.CBOX_LIGHT
