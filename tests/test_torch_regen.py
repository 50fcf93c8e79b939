"""The regenerative wavefront of the port against the JAX package (CPU):
Morton pixel order, camera rays for explicit sample ids, `sample_regen` per
sample against JAX's and against the port's own fixed-depth `sample`, the
`regen` rule of `render`, and the mesh20k golden z-test on the packet
route."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.integrators import common as jcommon
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.config import RGB
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators import common as tcommon
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_mesh import jax_mesh_scene
from test_torch_golden_specular import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mesh20k_path.npz")


def test_morton_pixel_order_matches_jax():
    W = H = 32
    mp = tcommon.morton_pixel_perm(W, H)
    assert mp.dtype == np.int64
    np.testing.assert_array_equal(mp, jcommon.morton_pixel_perm(W, H))
    assert np.sort(mp).tolist() == list(range(W * H))
    slots = np.arange(W * H)
    got = tcommon.morton_pixel_of(torch.as_tensor(slots), W).numpy()
    want = np.asarray(jcommon.morton_pixel_of(
        jnp.arange(W * H, dtype=jnp.uint32), W))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mp)
    for w, h in ((32, 16), (24, 24)):
        with pytest.raises(ValueError, match="power-of-two square"):
            tcommon.morton_pixel_perm(w, h)


@pytest.mark.parametrize("pixel_order", ["scanline", "morton"])
def test_camera_rays_at_matches_jax(pixel_order):
    """Explicit sample ids in no order, some of them repeated."""
    W = H = 32
    spp, seed = 4, 77
    rng = np.random.default_rng(1)
    sid = rng.integers(0, W * H * spp, 3000)
    jscene = jax_mesh_scene(W, H, 2)
    tscene = tpresets.mesh_scene(W, H, 2, device="cpu")
    jray, juv, _, _ = jcommon.camera_rays_at(
        jscene, seed, jnp.asarray(sid, jnp.uint32), W, H, spp, JRGB,
        pixel_order=pixel_order)
    tray, tuv = tcommon.camera_rays_at(tscene, seed, torch.as_tensor(sid), W,
                                       H, spp, pixel_order)
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    np.testing.assert_array_equal(tray.o.numpy(), np.asarray(jray.o))
    np.testing.assert_allclose(tray.d.numpy(), np.asarray(jray.d),
                               rtol=1e-6, atol=1e-7)
    assert torch.isinf(tray.maxt).all()
    # sample_rays is the same function on the sampler's own lanes
    s = Sampler.create(seed, W * H * spp, device="cpu")
    a, _ = tcommon.sample_rays(tscene, s, W, H, spp, pixel_order)
    b, _ = tcommon.camera_rays_at(tscene, seed, s.lane, W, H, spp,
                                  pixel_order)
    np.testing.assert_array_equal(a.d.numpy(), b.d.numpy())
    with pytest.raises(ValueError, match="pixel_order"):
        tcommon.camera_rays_at(tscene, seed, s.lane, W, H, spp, "hilbert")


@pytest.mark.parametrize("max_depth,rr_depth,pixel_order",
                         [(4, 2, "scanline"), (3, 9, "morton")])
def test_sample_regen_per_sample_matches_jax(max_depth, rr_depth,
                                             pixel_order):
    """JAX intersects through its XLA BVH walk on the CPU, the port through
    the plain packet walk: a sample may differ only where a bounce hits
    another triangle (a shared edge)."""
    W = H = 16
    spp, seed = 4, 5
    total = W * H * spp
    jscene = jax_mesh_scene(W, H, 5)
    jinteg = JPath(max_depth=max_depth, rr_depth=rr_depth)
    want = np.asarray(jax.jit(lambda s: jinteg.sample_regen(
        jscene, s, W, H, spp, JRGB, total // 8,
        pixel_order=pixel_order))(jnp.uint32(seed)))

    tscene = tpresets.mesh_scene(W, H, 5, accel="packet", device="cpu")
    stats = {}
    got = PathIntegrator(max_depth=max_depth, rr_depth=rr_depth).sample_regen(
        tscene, seed, W, H, spp, RGB, total // 8, pixel_order=pixel_order,
        stats=stats).numpy()
    assert got.shape == want.shape == (total, 3)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    print(f"per-sample agreement {close.mean():.6f}, "
          f"{stats['iterations']} iterations")
    assert close.mean() >= 0.999, close.mean()
    assert (want > 0).any(-1).mean() > 0.2
    # 8 samples a lane, each at least one bounce and at most max_depth
    assert 8 <= stats["iterations"] <= 8 * max_depth


@pytest.mark.parametrize("accel,pixel_order,n_lanes",
                         [("clu2", "scanline", 128), ("packet", "morton", 128),
                          ("packet", "scanline", 100)])
def test_sample_regen_equals_fixed_depth_sample(accel, pixel_order, n_lanes):
    """Same estimator, another schedule: every sample's value is that of
    the fixed-depth pass (rtol 2e-5, atol 2e-6, the tolerance of
    tests/test_regen.py). 100 lanes do not divide the 1,024 samples: the
    last round restarts only the lanes that still have a sample."""
    W = H = 16
    spp, seed = 4, 9
    total = W * H * spp
    scene = tpresets.mesh_scene(W, H, 5, accel=accel, device="cpu")
    integ = PathIntegrator(max_depth=4, rr_depth=2)
    s = Sampler.create(seed, total, device="cpu")
    ray, _ = tcommon.sample_rays(scene, s, W, H, spp, pixel_order)
    want, _ = integ.sample(scene, s, ray)
    got = integ.sample_regen(scene, seed, W, H, spp, RGB, n_lanes,
                             pixel_order=pixel_order)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    assert (want > 0).any(-1).float().mean() > 0.2


def test_render_regen_rule_and_morton_unscramble():
    """`regen=True` takes the regenerative wavefront only from 65,536
    samples a pass and only where the integrator has one; a Morton-order
    render equals the fixed-depth render of the same order and seed, and a
    scanline render to noise."""
    integ = PathIntegrator(max_depth=3, rr_depth=2)
    small = tpresets.mesh_scene(32, 32, 2, device="cpu")
    stats = {}
    a = tcommon.render(small, integ, seed=3, spp=2, regen=True, stats=stats)
    assert stats["regen_iterations"] == [] and stats["lanes_per_pass"] == 2048
    torch.testing.assert_close(a, tcommon.render(small, integ, seed=3, spp=2),
                               rtol=0, atol=0)
    grating = tpresets.grating_scene(8, 8, device="cpu")
    plt_integ = PLTIntegrator(max_depth=2)
    assert not hasattr(plt_integ, "sample_regen")
    tcommon.render(grating, plt_integ, spp=1, regen=True)

    scene = tpresets.mesh_scene(256, 256, 2, device="cpu")
    ops.reset_launch_counts()
    regen = tcommon.render(scene, integ, seed=3, spp=1, regen=True,
                           pixel_order="morton", stats=stats)
    assert stats["lanes_per_pass"] == 8192 and stats["n_pass"] == 1
    assert 8 <= stats["regen_iterations"][0] <= 24
    assert not any(ops.launch_counts().values())  # plain versions on the CPU
    fixed = tcommon.render(scene, integ, seed=3, spp=1, pixel_order="morton")
    torch.testing.assert_close(regen, fixed, rtol=2e-5, atol=2e-6)
    scan = tcommon.render(scene, integ, seed=3, spp=1)
    assert not torch.equal(scan, fixed)
    assert abs(scan.mean() - fixed.mean()) / scan.mean() < 0.02
    # the sphere's silhouette is in place: same lit pixels up to its rim
    assert ((scan > 0) != (fixed > 0)).float().mean() < 0.01


def test_packet_route_render_matches_golden_ztest():
    """The tests/test_golden.py mesh20k_path config on the packet route."""
    from scipy.stats import norm

    scene = tpresets.mesh_scene(32, 32, 5, accel="packet", device="cpu")
    assert scene.intersect_route() == "packet"
    integ = PathIntegrator(max_depth=3, rr_depth=9)
    imgs = np.stack([tcommon.render(scene, integ, seed=s, spp=8).numpy()
                     for s in range(4)])
    assert imgs.shape == (4, 32, 32, 3) and np.isfinite(imgs).all()
    ref = np.load(GOLDEN)
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    z = np.abs(mean - ref["mean"]) / np.sqrt((var + ref["var"]) / 4 + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    assert int((z > norm.isf(alpha / 2)).sum()) == 0, z.max()


def test_sample_regen_refuses_what_is_not_ported():
    # a constant emitter (the grating scene's, refused until the
    # environment branch was ported) and the glass box (u1 drawn at each
    # lane's own depth) take the regenerative wavefront: every sample
    # equals the fixed-depth pass's
    for scene in (tpresets.grating_scene(8, 8, device="cpu"),
                  tpresets.cornell_box(8, 8, box_material="dielectric",
                                       device="cpu")):
        integ = PathIntegrator(max_depth=4, rr_depth=2)
        s = Sampler.create(3, 8 * 8 * 2, device="cpu")
        ray, _ = tcommon.sample_rays(scene, s, 8, 8, 2)
        want, _ = integ.sample(scene, s, ray)
        got = integ.sample_regen(scene, 3, 8, 8, 2, RGB, 48)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
        assert (want > 0).any(-1).float().mean() > 0.05
    mesh = tpresets.mesh_scene(4, 4, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="hide_emitters"):
        PathIntegrator(hide_emitters=True).sample_regen(mesh, 0, 4, 4, 1,
                                                        RGB, 2)
    with pytest.raises(ValueError, match="n_lanes"):
        PathIntegrator().sample_regen(mesh, 0, 4, 4, 1, RGB, 0)
    # more lanes than samples: the spare lanes' values are trimmed
    stats = {}
    out = PathIntegrator(max_depth=2).sample_regen(mesh, 0, 4, 4, 2, RGB, 40,
                                                   stats=stats)
    assert out.shape == (32, 3) and 1 <= stats["iterations"] <= 2
