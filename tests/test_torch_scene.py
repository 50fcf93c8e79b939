"""Scene, camera and intersection of the port against the JAX package.

The JAX scene reaches the port through `scene_from_arrays`, from its leaves
keyed by pytree path; the port's own numpy preset must build the same
arrays. The plain q-form intersection runs against the Pallas q kernels in
interpret mode and against the chunked classic Möller-Trumbore oracle that
the JAX package runs on CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.ops.intersect_pallas import (
    pack_tri_q as j_pack_tri_q, pallas_intersect_q, pallas_occluded_q,
)
from mitsuba3_plt_tpu.scene import intersect as jisect
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene.bridge import STATIC_KEYS, scene_from_arrays


def jax_scene_arrays(scene):
    """(arrays keyed by pytree path, static fields) of a JAX Scene."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    arrays = {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
              for p, x in leaves}
    static = {
        "materials.present_types": scene.materials.present_types,
        "materials.grt_static": scene.materials.grt_static,
        "materials.mf_static": scene.materials.mf_static,
        "emitters.present_types": scene.emitters.present_types,
        "sensor.resolution": scene.sensor.resolution,
        "sensor.stype_static": scene.sensor.stype_static,
    }
    assert set(static) == set(STATIC_KEYS)
    return arrays, static


def _tensors(scene):
    out = {}
    for part in ("geo", "materials", "emitters", "sensor"):
        obj = getattr(scene, part)
        for name, val in vars(obj).items():
            out[f"{part}.{name}"] = val
    return out


PRESET_CASES = [
    dict(width=16, height=12),
    dict(width=24, height=24, coherence=1e3),
    dict(width=8, height=8, radial=True, lobes=5),
    dict(width=8, height=6, grt_type=1, inv_period=(0.6, 0.4), alpha=0.1),
]


@pytest.mark.parametrize("kw", PRESET_CASES)
def test_preset_arrays_equal_bridged_jax_scene(kw):
    kw = dict(kw)
    W, H = kw.pop("width"), kw.pop("height")
    jscene, _ = jpresets.grating_scene(W, H, **kw)
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    port = tpresets.grating_scene(W, H, device="cpu", **kw)
    a, b = _tensors(port), _tensors(bridged)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key


def test_bridge_refuses_unported_scenes():
    # area emitters and conductors: the Cornell box is not in this slice
    jscene, _ = jpresets.cornell_box(8, 8)
    with pytest.raises(NotImplementedError):
        scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    arrays, static = tpresets.grating_scene_arrays(4, 4)
    with pytest.raises(NotImplementedError):
        scene_from_arrays({**arrays, "geo.sph_center": np.zeros((1, 3))},
                          static, device="cpu")
    with pytest.raises(NotImplementedError):
        scene_from_arrays(arrays, {**static, "emitters.present_types": (0,)},
                          device="cpu")
    with pytest.raises(NotImplementedError):
        tpresets._emitters([{"type": "point", "radiance": (1, 1, 1)}], 1.0)


def test_camera_rays_match():
    W, H, spp = 20, 12, 3
    jscene, _ = jpresets.grating_scene(W, H)
    port = tpresets.grating_scene(W, H, device="cpu")
    n = W * H * spp
    js = JSampler.create(5, n).fork(2)
    jray, juv, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    ts = Sampler.create(5, n, device="cpu").fork(2)
    tray, tuv = sample_rays(port, ts, W, H, spp)
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-6)
    np.testing.assert_allclose(tray.o.numpy(), np.asarray(jray.o), atol=1e-6)
    np.testing.assert_allclose(tray.d.numpy(), np.asarray(jray.d), atol=1e-6)


def test_pack_tri_q_matches():
    mesh = jshape.make_sphere(subdiv=1)
    f, v = np.asarray(mesh.faces), np.asarray(mesh.vertices)
    p = [v[f[:, c]] for c in range(3)]
    want_q, want_a = j_pack_tri_q(*p)
    got_q, got_a = tisect.pack_tri_q(*p)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_a, want_a)


def _tables():
    """(name, p0, p1, p2): the grating scene's 4 triangles and a 320-face
    sphere soup."""
    out = []
    jscene, _ = jpresets.grating_scene(8, 8)
    g = jscene.geo
    out.append(("grating", np.asarray(g.tri_p0), np.asarray(g.tri_p1),
                np.asarray(g.tri_p2)))
    mesh = jshape.make_sphere(subdiv=2)
    f, v = np.asarray(mesh.faces), np.asarray(mesh.vertices)
    out.append(("sphere", v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]))
    return out


def _rays(kind, n, rng):
    if kind == "camera":
        port = tpresets.grating_scene(16, 16, device="cpu")
        ray, _ = sample_rays(port, Sampler.create(0, n, device="cpu"), 16, 16,
                             n // 256)
        return ray.o.numpy(), ray.d.numpy()
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if kind == "toward":  # aimed at the origin region: many hits
        d = -o + rng.normal(scale=0.3, size=(n, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("table", [0, 1])
@pytest.mark.parametrize("kind,maxt", [("camera", np.inf), ("random", np.inf),
                                       ("toward", np.inf), ("toward", 0.0),
                                       ("toward", "mixed")])
def test_intersect_q_plain_matches_jax(table, kind, maxt):
    rng = np.random.default_rng(table * 10 + len(kind))
    name, p0, p1, p2 = _tables()[table]
    n = 512
    o, d = _rays(kind, n, rng)
    if maxt == "mixed":
        mt = rng.uniform(0.5, 4.0, n).astype(np.float32)
        mt[::7] = np.inf
    else:
        mt = np.full(n, maxt, np.float32)
    tri_q, anchor = j_pack_tri_q(p0, p1, p2)
    rows = np.concatenate([p0, p1 - p0, p2 - p0], -1).astype(np.float32)
    rows = np.concatenate([rows, np.zeros(((-len(rows)) % 64, 9), np.float32)])
    jo, jd, jmt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt)
    jt, jprim, ju, jv = map(np.asarray, pallas_intersect_q(
        jnp.asarray(tri_q), jnp.asarray(anchor), jo, jd, jmt,
        interpret=True, n_tris=p0.shape[0]))
    ct, cprim, _, _ = map(np.asarray, jisect.chunked_intersect(
        jnp.asarray(rows), jo, jd, jmt))
    t, prim, u, v = (x.numpy() for x in tisect.intersect_q(
        torch.as_tensor(tri_q), torch.as_tensor(anchor), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(mt), n_tris=p0.shape[0]))
    assert prim.dtype == np.int32
    # the same algebra as the Pallas kernel: equal prims, tight values
    # (atol 1e-6 scene units for hits right at the origin, where t's
    # relative error grows as 1/t)
    np.testing.assert_array_equal(prim, jprim)
    hit = prim >= 0
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[hit], ju[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v[hit], jv[hit], rtol=1e-5, atol=1e-6)
    assert np.all(np.isinf(t[~hit]))
    # the classic form rounds differently: prims may differ only on ties
    # (a ray through a shared edge)
    same = prim == cprim
    assert same.mean() > 0.99
    both = same & hit
    np.testing.assert_allclose(t[both], ct[both], rtol=2e-4, atol=1e-5)
    if maxt == 0.0:
        assert not hit.any()


@pytest.mark.parametrize("table", [0, 1])
def test_occluded_q_plain_matches_pallas(table):
    rng = np.random.default_rng(40 + table)
    name, p0, p1, p2 = _tables()[table]
    n = 768
    o, d = _rays("toward", n, rng)
    mt = rng.uniform(0.0, 5.0, n).astype(np.float32)
    mt[::5] = np.inf
    mt[1::11] = 0.0
    tri_q, anchor = j_pack_tri_q(p0, p1, p2)
    want = np.asarray(pallas_occluded_q(
        jnp.asarray(tri_q), jnp.asarray(anchor), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(mt), interpret=True,
        n_tris=p0.shape[0]))
    got = tisect.occluded_q(
        torch.as_tensor(tri_q), torch.as_tensor(anchor), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(mt), n_tris=p0.shape[0]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95


def test_ray_intersect_surface_interaction_matches():
    W, H, spp = 16, 16, 2
    jscene, _ = jpresets.grating_scene(W, H)
    port = tpresets.grating_scene(W, H, device="cpu")
    n = W * H * spp
    js = JSampler.create(1, n)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    jsi = jscene.ray_intersect(jray)
    tray, _ = sample_rays(port, Sampler.create(1, n, device="cpu"), W, H,
                          spp)
    tsi = port.ray_intersect(tray)
    valid = tsi.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jsi.valid))
    for f in ("p", "n", "sh_s", "sh_t", "sh_n", "uv", "wi"):
        np.testing.assert_allclose(getattr(tsi, f).numpy()[valid],
                                   np.asarray(getattr(jsi, f))[valid],
                                   rtol=1e-5, atol=2e-6, err_msg=f)
    for f in ("mat_idx", "emitter_idx"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy(),
                                      np.asarray(getattr(jsi, f)))
