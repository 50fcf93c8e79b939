"""Big-mesh pieces of the port against the JAX package (CPU): the icosphere,
the native BVH, the two-level treelet tables, the plain clu2 closest-hit
and any-hit against the Pallas clu2 kernels in interpret mode, the point
emitter, the mesh scene's bridge and preset, and its routing."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba3_plt_tpu as mi
from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core import transform as jtf
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pallas_intersect_clu2, pallas_occluded_clu2,
)
from mitsuba3_plt_tpu.scene import emitters as jem
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu.scene.bvh import build_bvh as j_build_bvh
from mitsuba3_plt_tpu.scene.bvh import pack_clusters2 as j_pack_clusters2
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import emitters as tem
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from mitsuba3_plt_tpu_torch.scene.bvh import build_bvh, pack_clusters2
from test_torch_scene import _tensors, jax_scene_arrays
from test_torch_golden_specular import one_torch_thread  # noqa: F401

BVH_FIELDS = ("node_lo", "node_hi", "node_first", "node_count", "node_miss",
              "prim_idx")
CT_FIELDS = ("supers", "boxes", "rows", "anchor")


def jax_mesh_scene(W, H, subdiv):
    """The mesh scene through the JAX package's load_dict (the dict of
    tests/test_golden.py::_mesh20k and bench.py::bench_mesh_heavy)."""
    return mi.load_dict({
        "type": "scene",
        "sensor": {
            "type": "perspective", "fov": 45,
            "to_world": jtf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": W, "height": H},
        },
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [40, 40, 40]},
        "ball": {"type": "mesh", "mesh": jshape.make_sphere(subdiv=subdiv),
                 "bsdf": {"type": "diffuse", "reflectance": 0.7}},
    })[0]


def _soup(name):
    """(p0, p1, p2) of a triangle soup: "spheres" is the three spheres and
    ground plane of tests/test_isect_clu2.py (2,562 faces, several
    supers), "sphere20k" the 20,480-face icosphere, "twins" a 320-face
    sphere whose every face appears twice: every hit is an exact tie, which
    the first copy in table order must win in both packages."""
    if name == "spheres":
        parts = []
        for cx in (-2.5, 0.0, 2.5):
            m = jshape.make_sphere(subdiv=2)
            parts.append((np.asarray(m.vertices) + np.array([cx, 0, 0],
                                                            np.float32),
                          np.asarray(m.faces)))
        plane = jshape.make_rectangle()
        pv = np.asarray(plane.vertices) * 6.0
        pv[:, 1] -= 1.5
        parts.append((pv, np.asarray(plane.faces)))
    else:
        m = jshape.make_sphere(subdiv=5 if name == "sphere20k" else 2)
        f = np.asarray(m.faces)
        if name == "twins":
            f = np.repeat(f, 2, axis=0)
        parts = [(np.asarray(m.vertices), f)]
    p = [np.concatenate([v[f[:, c]] for v, f in parts]).astype(np.float32)
         for c in range(3)]
    return p


def _mesh_of(p):
    nf = len(p[0])
    faces = np.stack([np.arange(nf), np.arange(nf) + nf,
                      np.arange(nf) + 2 * nf], -1).astype(np.int32)
    return np.concatenate(p, 0), faces


@pytest.fixture(scope="module")
def tables():
    """{name: (JAX ClusterTable2, port ClusterTable2)}."""
    out = {}
    for name in ("spheres", "sphere20k", "twins"):
        p = _soup(name)
        verts, faces = _mesh_of(p)
        jct = j_pack_clusters2(j_build_bvh(verts, faces), *p)
        tct = pack_clusters2(build_bvh(verts, faces), *p, device="cpu")
        out[name] = (jct, tct)
    return out


def _rays(name, n, seed):
    """Rays from around z = -5 aimed at random points of the soup's box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=1.5, size=(n, 3)).astype(np.float32)
    o[:, 2] -= 5.0
    half = (3.6, 1.6, 1.1) if name == "spheres" else (1.1, 1.1, 1.1)
    d = rng.uniform(-1, 1, (n, 3)) * np.asarray(half) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("subdiv", [2, 5])
def test_make_sphere_matches_jax(subdiv):
    jm, tm = jshape.make_sphere(subdiv), tshape.make_sphere(subdiv)
    assert tm.faces.shape == (20 * 4 ** subdiv, 3)
    for field in ("vertices", "faces", "normals"):
        got, want = getattr(tm, field), np.asarray(getattr(jm, field))
        np.testing.assert_array_equal(got, want, err_msg=field)
        assert got.dtype == want.dtype, field


@pytest.mark.parametrize("name", ["spheres", "sphere20k"])
def test_build_bvh_matches_jax(name):
    verts, faces = _mesh_of(_soup(name))
    jb, tb = j_build_bvh(verts, faces), build_bvh(verts, faces)
    for field in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, field),
                                      np.asarray(getattr(jb, field)),
                                      err_msg=field)


@pytest.mark.parametrize("name", ["spheres", "sphere20k", "twins"])
def test_pack_clusters2_bit_identical(tables, name):
    jct, tct = tables[name]
    for field in CT_FIELDS:
        got = getattr(tct, field)
        assert got.dtype == torch.float32, field
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jct, field)),
                                      err_msg=field)
    if name == "sphere20k":
        assert tuple(tct.rows.shape) == (5312, 128)
        assert tuple(tct.boxes.shape) == (480, 16)


def _clu2_both(jct, tct, o, d, mt):
    jt, jp, ju, jv = map(np.asarray, pallas_intersect_clu2(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True))
    t, p, u, v = (x.numpy() for x in tisect.intersect_clu2(
        tct, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mt)))
    return (jt, jp, ju, jv), (t, p, u, v)


@pytest.mark.parametrize("name", ["spheres", "sphere20k", "twins"])
def test_intersect_clu2_plain_matches_jax_kernel(tables, name):
    jct, tct = tables[name]
    o, d = _rays(name, 1024, seed=len(name))
    mt = np.full(1024, np.inf, np.float32)
    mt[::9] = 4.5  # some segments end before the geometry
    (jt, jp, ju, jv), (t, p, u, v) = _clu2_both(jct, tct, o, d, mt)
    assert p.dtype == np.int32
    # the JAX clu2 tests' tolerances: prim on >= 99.9% of lanes (ties at
    # shared edges), t at 2e-5, u and v at rtol 1e-3 / atol 1e-4
    assert (p == jp).mean() >= 0.999, (p == jp).mean()
    same = (p >= 0) & (p == jp)
    assert same.mean() > 0.3
    np.testing.assert_allclose(t[same], jt[same], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-3, atol=1e-4)
    assert np.all(np.isinf(t[p < 0]))


@pytest.mark.parametrize("name", ["spheres", "sphere20k"])
def test_occluded_clu2_plain_matches_jax_kernel(tables, name):
    jct, tct = tables[name]
    o, d = _rays(name, 1024, seed=7 + len(name))
    t0 = np.asarray(tisect.intersect_clu2(
        tct, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((1024,), float("inf")))[0])
    rng = np.random.default_rng(11)
    # segments ending just short of / past the closest hit, random ones,
    # infinite and empty ones
    frac = rng.choice([0.95, 1.05], 1024)
    mt = np.where(np.isfinite(t0), t0 * frac, rng.uniform(0, 9, 1024))
    mt[::13] = np.inf
    mt[5::17] = 0.0
    mt = mt.astype(np.float32)
    want = np.asarray(pallas_occluded_clu2(
        jct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
        interpret=True))
    counts = {}
    got = tisect.occluded_clu2_plain(tct, torch.as_tensor(o),
                                     torch.as_tensor(d),
                                     torch.as_tensor(mt)).numpy()
    assert (got == want).mean() >= 0.999
    assert 0.1 < got.mean() < 0.9
    # the DFS walk without the gates tests every super of every lane and
    # gives the same answers
    dfs = tisect.occluded_clu2_dfs(tct, torch.as_tensor(o),
                                   torch.as_tensor(d), torch.as_tensor(mt),
                                   counts=counts).numpy()
    np.testing.assert_array_equal(dfs, got)
    assert counts["super_tests"] == 1024 * tct.supers.shape[0]
    assert 0 < counts["triangle_tests"] < 1024 * 4 * tct.rows.shape[0]


def test_clu2_dead_lane_convention(tables):
    """The canonical dead ray (o = 1e8, d = +z) misses everything."""
    _, tct = tables["sphere20k"]
    n = 256
    o = torch.full((n, 3), 1e8)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    counts = {}
    t, p, _, _ = tisect.intersect_clu2_plain(
        tct, o, d, torch.full((n,), float("inf")), counts=counts)
    assert (p == -1).all() and torch.isinf(t).all()
    assert counts["cluster_tests"] == 0 and counts["triangle_tests"] == 0
    occ = tisect.occluded_clu2(tct, o, d, torch.ones(n))
    assert not occ.any()


def test_clu2_wrappers_check_arguments(tables):
    import dataclasses

    _, tct = tables["spheres"]
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(TypeError):
        tisect.intersect_clu2(tct, o.double(), d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_clu2(tct, o, d[:4], mt)
    with pytest.raises(ValueError):
        tisect.intersect_clu2(
            dataclasses.replace(tct, rows=tct.rows[:, :64].contiguous()),
            o, d, mt)
    with pytest.raises(ValueError):
        tisect.occluded_clu2(
            dataclasses.replace(tct, anchor=torch.zeros(4)), o, d, mt)


def test_point_emitter_matches_jax():
    jscene = jax_mesh_scene(8, 8, 3)
    tscene = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    assert tscene.emitters.present_types == (tem.EMITTER_POINT,)
    rng = np.random.default_rng(5)
    n = 4096
    ref = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    active = rng.random(n) < 0.8
    jds = jem.sample_emitter_direction(
        jscene.emitters, jscene.geo, jnp.asarray(ref), jnp.asarray(u1),
        jnp.asarray(u2), jnp.asarray(active))
    tds = tem.sample_emitter_direction(
        tscene.emitters, tscene.geo, torch.as_tensor(ref),
        torch.as_tensor(u1),
        torch.as_tensor(u2), torch.as_tensor(active))
    for field in ("d", "dist", "pdf"):
        np.testing.assert_allclose(getattr(tds, field).numpy(),
                                   np.asarray(getattr(jds, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    for field in ("delta", "emitter_idx"):
        np.testing.assert_array_equal(getattr(tds, field).numpy(),
                                      np.asarray(getattr(jds, field)))
    want = np.asarray(jem.eval_emitter(
        jscene.emitters, jds.emitter_idx, jds.d, jds.dist,
        jnp.asarray(active)))
    got = tem.emitter_value(tscene.emitters, tds.emitter_idx, tds.d,
                            tds.dist, torch.as_tensor(active)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[active] > 0).all() and (got[~active] == 0).all()


def test_mesh_preset_arrays_equal_bridged_jax_scene():
    jscene = jax_mesh_scene(16, 16, 5)
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    port = tpresets.mesh_scene(16, 16, 5, device="cpu")
    a, b = _tensors(port), _tensors(bridged)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key
    for field in CT_FIELDS:
        np.testing.assert_array_equal(getattr(port.ctab2, field).numpy(),
                                      getattr(bridged.ctab2, field).numpy(),
                                      err_msg=field)


def test_bridge_refuses_big_mesh_without_ctab2():
    arrays, static = tpresets.mesh_scene_arrays(8, 8, 5)
    arrays = {k: v for k, v in arrays.items() if not k.startswith("ctab2.")}
    with pytest.raises(NotImplementedError, match="ctab2"):
        scene_from_arrays(arrays, static, device="cpu")
    # the small icosphere needs no treelet tables
    small = tpresets.mesh_scene(8, 8, 3, device="cpu")
    assert small.ctab2 is None and small.intersect_route() == "brute"


def test_mesh_ray_intersect_matches_jax():
    """Camera rays of the 20,480-face scene: the port's clu2 route against
    the JAX package's CPU route (its XLA BVH walk)."""
    W, H, spp = 24, 24, 2
    jscene = jax_mesh_scene(W, H, 5)
    port = tpresets.mesh_scene(W, H, 5, device="cpu")
    assert port.intersect_route() == "clu2"
    n = W * H * spp
    jray, _, _, _ = j_sample_rays(jscene, JSampler.create(2, n), W, H, spp,
                                  JRGB)
    jsi = jscene.ray_intersect(jray)
    tray, _ = sample_rays(port, Sampler.create(2, n, device="cpu"), W, H,
                          spp)
    tsi = port.ray_intersect(tray)
    prim, jprim = tsi.prim_idx.numpy(), np.asarray(jsi.prim_idx)
    # the q form and the walk's classic Moller-Trumbore round differently:
    # prims may differ only on shared edges
    assert (prim == jprim).mean() >= 0.999
    same = (prim == jprim) & (prim >= 0)
    assert same.mean() > 0.2
    for f in ("p", "n", "sh_n", "wi"):
        np.testing.assert_allclose(getattr(tsi, f).numpy()[same],
                                   np.asarray(getattr(jsi, f))[same],
                                   rtol=1e-4, atol=2e-5, err_msg=f)
    for f in ("valid", "mat_idx", "emitter_idx"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy(),
                                      np.asarray(getattr(jsi, f)))


def test_mesh_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpresets.mesh_scene(8, 8, 2)
    p = _soup("spheres")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_clusters2(build_bvh(*_mesh_of(p)), *p)
