"""The port's path tracer against the JAX package (CPU): per-lane radiance
on the 20,480-face mesh scene for the same seed, and the mesh20k golden
z-test of tests/test_golden.py."""
import os

import numpy as np
import jax
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import render, sample_rays
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_mesh import jax_mesh_scene
from test_torch_golden_specular import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mesh20k_path.npz")


@pytest.mark.parametrize("max_depth,rr_depth", [(3, 9), (4, 2)])
def test_path_radiance_per_lane_matches_jax(max_depth, rr_depth):
    """JAX intersects through its XLA BVH walk on the CPU, the port through
    the plain clu2 walk: a lane may differ only where a bounce hits another
    triangle (a shared edge)."""
    W = H = 16
    spp, seed = 4, 0
    n = W * H * spp
    jscene = jax_mesh_scene(W, H, 5)
    js = JSampler.create(seed, n).fork(0)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    integ = JPath(max_depth=max_depth, rr_depth=rr_depth)
    want = np.asarray(jax.jit(
        lambda s, r: integ.sample(jscene, s, r, None, JRGB)[0])(js, jray))

    tscene = tpresets.mesh_scene(W, H, 5, device="cpu")
    ts = Sampler.create(seed, n, device="cpu").fork(0)
    tray, _ = sample_rays(tscene, ts, W, H, spp)
    got, valid = PathIntegrator(max_depth=max_depth,
                                rr_depth=rr_depth).sample(tscene, ts, tray)
    got = got.numpy()
    assert valid.all() and got.shape == (n, 3)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    print(f"per-lane agreement {close.mean():.6f}")
    assert close.mean() >= 0.999, close.mean()
    assert (want > 0).any(-1).mean() > 0.2  # lit lanes are exercised


def test_path_render_matches_golden_ztest():
    """The tests/test_golden.py mesh20k_path config through the port."""
    from scipy.stats import norm

    scene = tpresets.mesh_scene(32, 32, 5, device="cpu")
    assert scene.intersect_route() == "clu2"
    integ = PathIntegrator(max_depth=3, rr_depth=9)
    ops.reset_launch_counts()
    imgs = np.stack([render(scene, integ, seed=s, spp=8).numpy()
                     for s in range(4)])
    assert ops.launch_counts()["intersect_clu2"] == 0  # plain on the CPU
    assert imgs.shape == (4, 32, 32, 3) and np.isfinite(imgs).all()
    ref = np.load(GOLDEN)
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    z = np.abs(mean - ref["mean"]) / np.sqrt((var + ref["var"]) / 4 + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    assert int((z > norm.isf(alpha / 2)).sum()) == 0, z.max()


def test_path_refuses_what_is_not_ported():
    """hide_emitters raises instead of rendering something else; a scene
    with a constant emitter (the grating scene's), refused until the
    environment branch was ported, now renders, and the escaped rays of
    the furnace see its radiance."""
    mesh = tpresets.mesh_scene(4, 4, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="hide_emitters"):
        render(mesh, PathIntegrator(hide_emitters=True), spp=1)
    furnace = tpresets.furnace_scene(4, 4, radiance=2.0, device="cpu")
    with pytest.raises(NotImplementedError, match="hide_emitters"):
        render(furnace, PathIntegrator(hide_emitters=True), spp=1)
    scene = tpresets.grating_scene(4, 4, device="cpu")
    img = render(scene, PathIntegrator(max_depth=2), spp=1)
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
    corner = render(furnace, PathIntegrator(max_depth=2), spp=1)[0, 0]
    np.testing.assert_array_equal(corner.numpy(), [2.0, 2.0, 2.0])


def test_path_render_on_small_mesh_takes_the_brute_route():
    """Up to 4096 faces the path tracer runs on the q route."""
    scene = tpresets.mesh_scene(8, 8, 3, device="cpu")
    assert scene.intersect_route() == "brute" and scene.ctab2 is None
    img = render(scene, PathIntegrator(max_depth=3, rr_depth=2), seed=1,
                 spp=4)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert img.mean() > 0
