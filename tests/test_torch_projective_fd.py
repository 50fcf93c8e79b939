"""The port's boundary gradients on the CPU, continued from
`test_torch_projective.py` (its scenes and helpers): `render_loss_grad`'s
boundary on a scene without an area light (where JAX's raises), and
`tests/test_projective.py`'s finite-difference checks through the port at
JAX's tolerances and sample counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_plt_tpu as mi
from mitsuba3_plt_tpu.ad import projective as jp
import mitsuba3_plt_tpu_torch as tmi
from mitsuba3_plt_tpu_torch import ad
from mitsuba3_plt_tpu_torch.ad import projective as tp
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from mitsuba3_plt_tpu_torch.scene.presets import BOUNDARY_ROWS as ROWS
from test_torch_projective import KEYS, SCENES, WMAP, both, loss


def test_render_loss_grad_boundary_without_area_lights():
    """The point-light scene through render_loss_grad: JAX's guided
    penumbra term unpacks its zero dict as (cotangents, mass) and raises
    where the scene has no area light; the port's gives zero, so the sum
    is the camera and shadow terms."""
    js, ts, ji, ti = both("shadow")
    with pytest.raises(ValueError):  # render_loss_grad's last term
        jp.area_nee_boundary_grad_guided(js, jnp.asarray(WMAP), key=1,
                                         n_samples=256, cfg=mi.config())
    _, got = ad.render_loss_grad(ts, ti.sample, loss, KEYS, seed=1, spp=1,
                                 geometry_boundary=True,
                                 boundary_samples=1024)
    g_img = torch.as_tensor(WMAP)
    prim = tp.primary_boundary_grad(ts, ti.sample, g_img, key=1 + 0x9E37,
                                    n_samples=1024)
    nee = tp.nee_boundary_grad(ts, ti.sample, g_img, key=1 + 0x85EB,
                               n_samples=1024)
    assert not any(tp.area_nee_boundary_grad_guided(
        ts, g_img, n_samples=1024)[k].any() for k in KEYS)
    for k in KEYS:
        torch.testing.assert_close(got[k], prim[k] + nee[k], rtol=0,
                                   atol=0)
    assert any(nee[k][ROWS["shadow"]].abs().max() > 0 for k in KEYS)


# ---------------------------------------------------------------------------
# test_projective.py's finite-difference checks through the port
# ---------------------------------------------------------------------------

def fd(name, eps, spp):
    """Central difference of the loss under an x-translation of the
    scene's moving object (same seed both sides)."""
    f = []
    for delta in (eps, -eps):
        scene = tmi.load_dict(SCENES[name](delta), device="cpu")
        f.append(float(loss(tmi.render(scene, spp=spp, seed=7)).double()))
    return (f[0] - f[1]) / (2 * eps)


def x_sum(cots, rows=slice(None)):
    return sum(float(cots[k][rows, 0].sum()) for k in KEYS)


@pytest.mark.parametrize("name", ["rectangle", "cube"])
def test_boundary_grad_vs_fd(name):
    _, ts, _, ti = both(name)
    want = fd(name, 0.05, 256)
    g = x_sum(tp.primary_boundary_grad(ts, ti.sample,
                                       torch.as_tensor(WMAP), key=3,
                                       n_samples=1 << 14))
    assert abs(want) > 100.0
    assert abs(g - want) / abs(want) < 0.12, (g, want)


def test_render_loss_grad_geometry_boundary_vs_fd():
    _, ts, _, ti = both("rectangle")
    want = fd("rectangle", 0.05, 256)
    _, grads = ad.render_loss_grad(ts, ti.sample, loss, KEYS, seed=5,
                                   spp=64, geometry_boundary=True)
    g = x_sum(grads)
    assert abs(g - want) / abs(want) < 0.15, (g, want)


def test_boundary_zero_without_silhouette_motion():
    """A y-translation with the x-ramp weights: the top edge sweeps in
    what the bottom edge sweeps out."""
    _, ts, _, ti = both("rectangle")
    cots = tp.primary_boundary_grad(ts, ti.sample, torch.as_tensor(WMAP),
                                    key=3, n_samples=1 << 13)
    gy = sum(float(cots[k][:, 1].sum()) for k in KEYS)
    assert abs(gy) < 0.1 * abs(x_sum(cots)), (gy, x_sum(cots))


def test_nee_boundary_grad_vs_fd():
    _, ts, _, ti = both("shadow")
    want = fd("shadow", 0.04, 256)
    g = x_sum(tp.nee_boundary_grad(ts, ti.sample, torch.as_tensor(WMAP),
                                   key=3, n_samples=1 << 14),
              ROWS["shadow"])
    assert abs(want) > 1.0, want
    assert abs(g - want) / abs(want) < 0.2, (g, want)


def test_area_penumbra_grad_vs_fd():
    _, ts, _, _ = both("penumbra")
    want = fd("penumbra", 0.05, 384)
    g = x_sum(tp.area_nee_boundary_grad(ts, torch.as_tensor(WMAP), key=3,
                                        n_samples=1 << 15),
              ROWS["penumbra"])
    assert abs(want) > 1.0, want
    assert abs(g - want) / abs(want) < 0.25, (g, want)


def test_area_penumbra_guiding_reduces_variance():
    """Guided edge sampling cuts the variance at an equal budget and
    keeps the mean (test_projective.py's check)."""
    _, ts, _, _ = both("penumbra")
    w = torch.as_tensor(WMAP)

    def g_of(fn, key):
        return x_sum(fn(ts, w, key=key, n_samples=1 << 12),
                     ROWS["penumbra"])

    uni = np.array([g_of(tp.area_nee_boundary_grad, 11 + 31 * k)
                    for k in range(8)])
    gui = np.array([g_of(tp.area_nee_boundary_grad_guided, 11 + 31 * k)
                    for k in range(8)])
    se = np.sqrt(uni.var() / 8 + gui.var() / 8)
    assert abs(uni.mean() - gui.mean()) < 4 * se + 0.05 * abs(uni.mean()), (
        uni.mean(), gui.mean(), se)
    assert gui.std() < 0.8 * uni.std(), (gui.std(), uni.std())
