"""The Cornell box in the port against the JAX package (CPU): the unit
rectangle and cube, the preset's arrays leaf for leaf (the (p0, e1, e2)
rows and the area-light tables included), area-light sampling and its
density, per-lane path radiance, and the cbox_path golden z-test of
tests/test_golden.py."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core import transform as jtf
from mitsuba3_plt_tpu.core import warp as jwarp
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.librender.records import DirectionSample as JDS
from mitsuba3_plt_tpu.scene import emitters as jem
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.core import warp
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import render, sample_rays
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.scene import emitters as tem
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from test_torch_scene import _tensors, jax_scene_arrays
from test_torch_golden_specular import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cbox_path.npz")


@pytest.fixture(scope="module")
def scenes():
    """(JAX cornell_box(16, 16), the port's on the CPU)."""
    return (jpresets.cornell_box(16, 16)[0],
            tpresets.cornell_box(16, 16, device="cpu"))


@pytest.mark.parametrize("kind", ["rectangle", "cube"])
def test_rectangle_and_cube_match_jax(kind):
    to_world = (jtf.translate([0.3, -0.7, 0.4]) @ jtf.rotate([0, 1, 0], -17)
                @ jtf.scale([0.25, 0.3, 0.25])).astype(np.float32)
    jm = getattr(jshape, "make_" + kind)().transformed(to_world)
    v, f, n, uv = getattr(tshape, "make_" + kind)(to_world)
    np.testing.assert_array_equal(v, jm.vertices)
    np.testing.assert_array_equal(f, jm.faces)
    assert v.dtype == np.float32 and f.dtype == np.int32
    if kind == "cube":
        assert jm.face_normals and n is None and uv is None
        assert f.shape == (12, 3)
    else:
        np.testing.assert_array_equal(n, jm.normals)
        np.testing.assert_array_equal(uv, jm.uvs)


def test_cbox_preset_arrays_equal_bridged_jax_scene(scenes):
    jscene, port = scenes
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    a, b = _tensors(port), _tensors(bridged)
    assert a.keys() == b.keys()
    for key in ("geo.tri_isect", "emitters.tri_idx", "emitters.tri_cdf",
                "emitters.area"):
        assert key in a
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key
    assert port.geo.n_faces == 36 and port.intersect_route() == "brute"
    assert tuple(port.geo.tri_isect.shape) == (64, 9)
    np.testing.assert_array_equal(port.geo.tri_isect.numpy(),
                                  np.asarray(jscene.geo.tri_isect))
    assert port.emitters.present_types == (tem.EMITTER_AREA,)
    assert port.emitters.tri_idx.tolist() == [[34, 35]]


def test_square_to_uniform_triangle_matches_jax():
    u = np.random.default_rng(3).random((1000, 2)).astype(np.float32)
    want = np.asarray(jwarp.square_to_uniform_triangle(jnp.asarray(u)))
    got = warp.square_to_uniform_triangle(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got >= 0).all() and (got.sum(-1) <= 1 + 1e-6).all()


def test_area_sampling_and_pdf_match_jax(scenes):
    """NEE toward the area light from points inside the box, on the same
    uniforms, and the solid-angle density of those samples, at rtol 1e-5."""
    jscene, port = scenes
    rng = np.random.default_rng(8)
    n = 4096
    ref = rng.uniform([-0.95, -0.95, -0.95], [0.95, 0.95, 0.95],
                      (n, 3)).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    active = rng.random(n) < 0.9
    jds = jem.sample_emitter_direction(
        jscene.emitters, jscene.geo, jnp.asarray(ref), jnp.asarray(u1),
        jnp.asarray(u2), jnp.asarray(active))
    tds = tem.sample_emitter_direction(
        port.emitters, port.geo, torch.as_tensor(ref), torch.as_tensor(u1),
        torch.as_tensor(u2), torch.as_tensor(active))
    for field in ("p", "n", "uv", "d", "dist", "pdf"):
        np.testing.assert_allclose(getattr(tds, field).numpy(),
                                   np.asarray(getattr(jds, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    for field in ("delta", "emitter_idx"):
        np.testing.assert_array_equal(getattr(tds, field).numpy(),
                                      np.asarray(getattr(jds, field)))
    assert (tds.pdf.numpy()[active] > 0).mean() > 0.95
    # both light triangles are picked, points stay on the light
    p = tds.p.numpy()
    assert np.allclose(p[:, 1], 0.99, atol=1e-6)
    assert (p[:, 0] < 0).any() and (p[:, 0] > 0).any()

    # the density of the same samples, as an emitter hit sees it (ds.n is
    # the light's normal): the sampled pdf without the active mask
    want = np.asarray(jem.pdf_emitter_direction(
        jscene.emitters, jscene.geo, jnp.asarray(ref), JDS(
            p=jds.p, n=jds.n, uv=jds.uv, d=jds.d, dist=jds.dist,
            pdf=jds.pdf, delta=jds.delta, emitter_idx=jds.emitter_idx)))
    got = tem.pdf_emitter_direction(port.emitters, port.geo,
                                    torch.as_tensor(ref), tds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    lit = active & (got > 0)
    np.testing.assert_allclose(got[lit], tds.pdf.numpy()[lit], rtol=1e-5)

    e_want = np.asarray(jem.eval_emitter(
        jscene.emitters, jds.emitter_idx, jds.d, jds.dist,
        jnp.asarray(active)))
    e_got = tem.emitter_value(port.emitters, tds.emitter_idx, tds.d,
                              tds.dist, torch.as_tensor(active)).numpy()
    np.testing.assert_array_equal(e_got, e_want)


@pytest.mark.parametrize("max_depth,rr_depth", [(4, 9), (5, 2)])
def test_cbox_path_radiance_per_lane_matches_jax(scenes, max_depth,
                                                  rr_depth):
    """JAX intersects through its chunked classic scan on the CPU, the port
    through the plain q loop: both hit the same triangles here, so every
    lane agrees."""
    jscene, port = scenes
    W = H = 16
    spp, seed = 4, 0
    n = W * H * spp
    js = JSampler.create(seed, n).fork(0)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    integ = JPath(max_depth=max_depth, rr_depth=rr_depth)
    want = np.asarray(jax.jit(
        lambda s, r: integ.sample(jscene, s, r, None, JRGB)[0])(js, jray))

    ts = Sampler.create(seed, n, device="cpu").fork(0)
    tray, _ = sample_rays(port, ts, W, H, spp)
    got, valid = PathIntegrator(max_depth=max_depth,
                                rr_depth=rr_depth).sample(port, ts, tray)
    got = got.numpy()
    assert valid.all() and got.shape == (n, 3)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    print(f"per-lane agreement {close.mean():.6f}")
    assert close.all(), close.mean()
    assert (want > 0).any(-1).mean() > 0.5  # lit lanes are exercised
    assert (want > 1.0).any(-1).any()       # and lanes that see the light


def test_cbox_render_matches_golden_ztest():
    """The tests/test_golden.py cbox_path config through the port: 32x32,
    path depth 4 / rr 9, 4 seeds x 16 spp."""
    from scipy.stats import norm

    scene = tpresets.cornell_box(32, 32, device="cpu")
    integ = PathIntegrator(max_depth=4, rr_depth=9)
    ops.reset_launch_counts()
    imgs = np.stack([render(scene, integ, seed=s, spp=16).numpy()
                     for s in range(4)])
    assert ops.launch_counts()["intersect_q"] == 0  # plain on the CPU
    assert imgs.shape == (4, 32, 32, 3) and np.isfinite(imgs).all()
    ref = np.load(GOLDEN)
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    z = np.abs(mean - ref["mean"]) / np.sqrt((var + ref["var"]) / 4 + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    assert int((z > norm.isf(alpha / 2)).sum()) == 0, z.max()


def test_cornell_box_refuses_what_is_not_ported():
    # every box material of the JAX preset is ported, an unknown name
    # raises (the JAX preset would take its diffuse default), and tables the
    # port has no BSDF for (plastic, rough dielectric) come through the
    # bridge refused
    import dataclasses

    with pytest.raises(ValueError, match="box_material"):
        tpresets.cornell_box(8, 8, box_material="plastic", device="cpu")
    for material in ("conductor", "dielectric"):
        jscene, _ = jpresets.cornell_box(8, 8, box_material=material)
        scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
        jm = dataclasses.replace(
            jscene.materials, mtype=jscene.materials.mtype.at[3].set(7),
            present_types=(1, 7))
        with pytest.raises(NotImplementedError, match="not all ported"):
            scene_from_arrays(*jax_scene_arrays(
                dataclasses.replace(jscene, materials=jm)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpresets.cornell_box(8, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpresets.cornell_box(8, 8, box_material="dielectric")
    # the port's box is the JAX default's: diffuse boxes, light at scale 1
    a = tpresets.cornell_box_arrays(8, 8)[0]
    b = jax_scene_arrays(jpresets.cornell_box(8, 8)[0])[0]
    np.testing.assert_array_equal(a["emitters.radiance"],
                                  b["emitters.radiance"])
    np.testing.assert_array_equal(a["materials.mtype"],
                                  b["materials.mtype"])
