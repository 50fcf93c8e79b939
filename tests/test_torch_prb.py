"""The port's PRB integrator (CPU): its primal against the port's path
tracer, its image and gradients against the JAX package's PRBIntegrator
on the same seed, and its gradient against autograd through the path
tracer (the remat gradient), on cornell_box(12, 12). The JAX references
are computed once per module."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ad import render as jrender
from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.integrators.prb import PRBIntegrator as JPRB
from mitsuba3_plt_tpu.scene.presets import cornell_box as jcornell_box
from mitsuba3_plt_tpu_torch import ad
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.prb import PRBIntegrator
from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
from test_torch_golden_specular import one_torch_thread  # noqa: F401

W = H = 12
DEPTH, RR, SPP = 3, 8, 8
KEYS = ("materials.base_color", "emitters.radiance")


@pytest.fixture(scope="module")
def scene():
    return cornell_box(W, H, device="cpu")


@pytest.fixture(scope="module")
def jax_prb():
    jscene, _ = jcornell_box(W, H)
    integ = JPRB(max_depth=DEPTH, rr_depth=RR)
    img = jrender.render_differentiable(jscene, integ.sample, seed=0,
                                        spp=SPP, cfg=JRGB)
    loss, grads = jrender.render_loss_grad(
        jscene, integ.sample, jnp.mean, list(KEYS), seed=0, spp=SPP,
        cfg=JRGB)
    return np.asarray(img), float(loss), {k: np.asarray(v)
                                          for k, v in grads.items()}


def test_prb_primal_matches_path(scene):
    """PRB's value is the detached path tracer's (tests/test_prb.py's
    bound, rtol 2e-4): the same samples, summed by a prefix product."""
    path = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    prb = PRBIntegrator(max_depth=DEPTH, rr_depth=RR)
    img_p = ad.render_differentiable(scene, path.sample, seed=0, spp=SPP)
    img_r = ad.render_differentiable(scene, prb.sample, seed=0, spp=SPP)
    np.testing.assert_allclose(img_r.numpy(), img_p.numpy(), rtol=2e-4,
                               atol=2e-4)
    # and through the plain render loop, under no_grad
    img_n = render(scene, prb, seed=0, spp=SPP)
    np.testing.assert_allclose(img_n.numpy(), img_r.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_prb_image_matches_jax(scene, jax_prb):
    prb = PRBIntegrator(max_depth=DEPTH, rr_depth=RR)
    img = ad.render_differentiable(scene, prb.sample, seed=0, spp=SPP)
    # the same samples and record: float32 rounding of the same sums
    np.testing.assert_allclose(img.numpy(), jax_prb[0], rtol=1e-5,
                               atol=1e-6)


def test_prb_grads_match_jax(scene, jax_prb):
    prb = PRBIntegrator(max_depth=DEPTH, rr_depth=RR)
    loss, grads = ad.render_loss_grad(scene, prb.sample, torch.mean,
                                      list(KEYS), seed=0, spp=SPP)
    _, jloss, jgrads = jax_prb
    assert abs(float(loss) - jloss) <= 1e-6 * jloss
    for k in KEYS:
        want = jgrads[k]
        assert np.abs(want).max() > 0
        # float32 rounding of the same replay sums, relative to the largest
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_prb_grad_agrees_with_remat(scene):
    """PRB (detached sampling) and autograd through the path tracer
    estimate the same albedo derivative: with one seed within 0.1 of the
    largest entry (tests/test_prb.py's bound)."""
    path = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    prb = PRBIntegrator(max_depth=DEPTH, rr_depth=RR)
    key = "materials.base_color"
    _, g_remat = ad.render_loss_grad(scene, path.sample, torch.mean, [key],
                                     seed=0, spp=32)
    _, g_prb = ad.render_loss_grad(scene, prb.sample, torch.mean, [key],
                                   seed=0, spp=32)
    a, b = g_remat[key].numpy(), g_prb[key].numpy()
    denom = max(np.abs(a).max(), np.abs(b).max())
    assert np.abs(a - b).max() < 0.1 * denom, (a, b)


def test_prb_emitter_grad_matches_finite_difference(scene):
    """tests/test_prb.py's check on the port: the light's red radiance
    gradient against a central difference of the same estimator."""
    prb = PRBIntegrator(max_depth=2, rr_depth=RR)
    key = "emitters.radiance"
    _, grads = ad.render_loss_grad(scene, prb.sample, torch.mean, [key],
                                   seed=0, spp=SPP)
    params = ad.traverse(scene)
    rad, eps = params[key], 1e-2

    def run(delta):
        p = rad.clone()
        p[0, 0] += delta
        return float(ad.render_differentiable(
            params.update({key: p}), prb.sample, seed=0,
            spp=SPP).double().mean())

    fd = (run(eps) - run(-eps)) / (2 * eps)
    g = float(grads[key][0, 0])
    assert abs(fd - g) < 0.05 * max(abs(fd), abs(g), 1e-3), (fd, g)
