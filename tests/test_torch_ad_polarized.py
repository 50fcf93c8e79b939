"""Polarized gradients of the port against the JAX package (CPU), and the
renders' TF32 flags.

- Polarized PLT (RGB_POLARIZED, film S0) on grating_scene(16, 16), depth
  3, 8 spp: `render_loss_grad` of the mean image on the base colour and
  the four grating parameters against `jax.grad`; the height's against a
  float64 central difference of the port's render, since jax.grad there
  differentiates JAX's float32 Miller recurrence (ROADMAP C7).
- The Stokes path (`StokesIntegrator(PolarizedPathIntegrator(3, 9))`, 15
  channels) on the conductor box at 16x16 (the glass box is
  `test_torch_ad_polarized_glass.py`'s), the mean of the image: the base
  colour and the index (eta_re, eta_im) against jax.grad of JAX's render
  with its NaN sources patched in this process (`jax_nan_safe`: JAX's own
  index gradient is NaN, ROADMAP C8; each source is shown NaN in JAX and
  finite in the port), and the index also against a float64 central
  difference. The glass's cannot be: its lobe pdf and hit distances are
  detached, so a fixed-seed difference misses the lobe flips that carry
  its expectation.
- The diffuse box's Stokes S0 gradient against the scalar path's.
- `render`, `render_differentiable`, `render_loss_grad`, `render_grad`
  and PRB's `sample` leave a caller's TF32 flags as they found them (C-P1).

The JAX renders run under `jax.jit` with the scene a constant: one
compiled program each instead of op-by-op compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_plt_tpu.ad import render as jrender
from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.config import RGB_POLARIZED as JPOL
from mitsuba3_plt_tpu.core import math as jm
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.integrators.stokes import (
    PolarizedPathIntegrator as JPPI, StokesIntegrator as JStokes)
from mitsuba3_plt_tpu.librender import fresnel as jf
from mitsuba3_plt_tpu.scene import intersect as jisect
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch import ad
from mitsuba3_plt_tpu_torch.config import RGB_POLARIZED
from mitsuba3_plt_tpu_torch.core.device import fp32_matmul
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.integrators.prb import PRBIntegrator
from mitsuba3_plt_tpu_torch.integrators.stokes import (
    PolarizedPathIntegrator, StokesIntegrator)
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_golden_specular import one_torch_thread  # noqa: F401

PLT_KEYS = ("materials.base_color", "materials.grt_inv_period",
            "materials.grt_height", "materials.grt_multiplier",
            "materials.grt_coherence")
PLT_DEPTH, PLT_RR, PLT_SPP = 3, 8, 8
HEIGHT_EPS = 1e-4
BOX = 16
STOKES_DEPTH, STOKES_RR, STOKES_SPP = 3, 9, 8


def jax_loss_grad(jscene, sample, keys, cfg, spp, loss=jnp.mean):
    """(loss, {key: gradient}) of the JAX package's render_loss_grad,
    compiled once with the scene a constant."""
    loss_v, grads = jax.jit(lambda: jrender.render_loss_grad(
        jscene, sample, loss, list(keys), seed=0, spp=spp, cfg=cfg))()
    return float(loss_v), {k: np.asarray(v) for k, v in grads.items()}


def hold(got, want, key, rtol=1e-4):
    """The port's gradient against JAX's: rtol of each entry plus 1e-5 of
    the largest (float32 rounding of the same chain rule)."""
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0, key
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale,
                               err_msg=key)


# ---------------------------------------------------------------------------
# polarized PLT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plt_pol():
    jscene, _ = jpresets.grating_scene(16, 16, coherence=5e3)
    scene = tpresets.grating_scene(16, 16, coherence=5e3, device="cpu")
    want = jax_loss_grad(jscene, JPLT(PLT_DEPTH, PLT_RR).sample, PLT_KEYS,
                         JPOL, PLT_SPP)
    got = ad.render_loss_grad(scene, PLTIntegrator(PLT_DEPTH, PLT_RR).sample,
                              torch.mean, list(PLT_KEYS), seed=0,
                              spp=PLT_SPP, cfg=RGB_POLARIZED)
    return scene, want, got


def test_polarized_plt_runs_the_recording_lobe_sum(monkeypatch):
    """Under polarized PLT the gradient pass's lobe sums are recorded (on
    the card: B4's recording instance, whose bits B4b reads) and their
    backward runs (`grating_lobe_sum_bwd`, its plain version here)."""
    from mitsuba3_plt_tpu_torch.ops import grating as g

    records, bwd = [], []
    real_records, real_bwd = g.autograd_records, g.grating_lobe_sum_bwd

    def spy_records(args):
        records.append(real_records(args))
        return records[-1]

    def spy_bwd(*a, **kw):
        bwd.append(1)
        return real_bwd(*a, **kw)

    monkeypatch.setattr(g, "autograd_records", spy_records)
    monkeypatch.setattr(g, "grating_lobe_sum_bwd", spy_bwd)
    scene = tpresets.grating_scene(8, 8, coherence=5e3, device="cpu")
    ad.render_loss_grad(scene, PLTIntegrator(2, 8).sample, torch.mean,
                        ["materials.grt_height"], seed=0, spp=1,
                        cfg=RGB_POLARIZED)
    assert records and all(records) and bwd


@pytest.mark.parametrize("key", PLT_KEYS)
def test_polarized_plt_grads_match_jax(plt_pol, key):
    scene, (jloss, jgrads), (loss, grads) = plt_pol
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    got, want = grads[key].numpy(), jgrads[key]
    if key == "materials.grt_height":
        integ = PLTIntegrator(PLT_DEPTH, PLT_RR)
        params = ad.traverse(scene)

        def run(delta):
            p = params[key].clone()
            p[1] += delta
            return float(ad.render_differentiable(
                params.update({key: p}), integ.sample, seed=0, spp=PLT_SPP,
                cfg=RGB_POLARIZED).double().mean())

        fd = (run(HEIGHT_EPS) - run(-HEIGHT_EPS)) / (2 * HEIGHT_EPS)
        assert np.sign(got[1]) == np.sign(want[1]) and got[0] == 0.0
        assert abs(got[1] - fd) <= 1e-3 * abs(fd), (got[1], fd, want[1])
    else:
        hold(got, want, key)


# ---------------------------------------------------------------------------
# the Stokes path
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_nan_safe(monkeypatch):
    """The JAX package's NaN sources of a polarized index gradient,
    patched in this process only (its files stay as they are), each as
    the port repairs it and keeping every value a render reads: the
    rotation angle's norm and the complex root take `safe_sqrt`, the
    dielectric's Fresnel divides by 1 under total internal reflection, and
    a zero index (another type's row) is taken as 1. And its hit search
    takes the detached ray, as on its TPU route and in the port (the CPU
    route's chunked search differentiates t through the ray: the refracted
    paths' index gradient then carries d t / d eta, which neither the TPU
    route nor the port has)."""
    def unit_angle(u, v):
        dot_uv = jnp.sum(u * v, axis=-1)
        w = jnp.where(dot_uv[..., None] < 0, u + v, u - v)
        theta = 2.0 * jm.safe_asin(0.5 * jm.safe_sqrt(jnp.sum(w * w, -1)))
        return jnp.where(dot_uv < 0, jm.Pi - theta, theta)

    def c_sqrt(a):
        r = jm.safe_sqrt(a[0] * a[0] + a[1] * a[1])
        re = jm.safe_sqrt(0.5 * (r + a[0]))
        im_mag = jm.safe_sqrt(0.5 * (r - a[0]))
        return re, jnp.where(a[1] >= 0, im_mag, -im_mag)

    def fresnel_dielectric(cos_theta_i, eta):
        outside = cos_theta_i >= 0.0
        eta = jnp.where(eta == 0.0, 1.0, eta)
        rcp_eta = 1.0 / eta
        eta_it = jnp.where(outside, eta, rcp_eta)
        eta_ti = jnp.where(outside, rcp_eta, eta)
        ctt_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
        cia = jnp.abs(cos_theta_i)
        cta = jm.safe_sqrt(ctt_sqr)
        tir = ctt_sqr <= 0.0
        a_s = (cia - eta_it * cta) / jnp.where(tir, 1.0, cia + eta_it * cta)
        a_p = (eta_it * cia - cta) / jnp.where(tir, 1.0, eta_it * cia + cta)
        F = jnp.where(tir, 1.0, 0.5 * (a_s * a_s + a_p * a_p))
        F = jnp.where(eta == 1.0, 0.0, F)
        cos_theta_t = jnp.where(tir, 0.0, jm.mulsign_neg(cta, cos_theta_i))
        return F, cos_theta_t, eta_it, eta_ti

    real_fpd = jf.fresnel_polarized_dielectric

    def fresnel_polarized_dielectric(cos_theta_i, eta):
        return real_fpd(cos_theta_i, jnp.where(eta == 0.0, 1.0, eta))

    def detached_search(tri_isect, o, d, maxt):
        sg = jax.lax.stop_gradient
        return real_search(tri_isect, sg(o), sg(d), sg(maxt))

    real_search = jisect.chunked_intersect
    monkeypatch.setattr(jisect, "chunked_intersect", detached_search)
    monkeypatch.setattr(jm, "unit_angle", unit_angle)
    monkeypatch.setattr(jf, "c_sqrt", c_sqrt)
    monkeypatch.setattr(jf, "fresnel_dielectric", fresnel_dielectric)
    monkeypatch.setattr(jf, "fresnel_polarized_dielectric",
                        fresnel_polarized_dielectric)


def stokes_boxes(box):
    jscene, _ = jpresets.cornell_box(BOX, BOX, box_material=box)
    scene = tpresets.cornell_box(BOX, BOX, box_material=box, device="cpu")
    return (jscene, scene,
            JStokes(JPPI(STOKES_DEPTH, STOKES_RR)).sample,
            StokesIntegrator(PolarizedPathIntegrator(STOKES_DEPTH,
                                                     STOKES_RR)).sample)


ETA_KEYS = {"dielectric": ("materials.eta_re",),
            "conductor": ("materials.eta_re", "materials.eta_im")}


def stokes_grads_match_jax(box):
    jscene, scene, jsample, tsample = stokes_boxes(box)
    keys = ("materials.base_color",) + ETA_KEYS[box]
    jloss, want = jax_loss_grad(jscene, jsample, keys, JRGB, STOKES_SPP)
    loss, got = ad.render_loss_grad(scene, tsample, torch.mean, list(keys),
                                    seed=0, spp=STOKES_SPP)
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    for k in keys:
        hold(got[k].numpy(), want[k], k, rtol=1e-3)
    assert np.abs(want[ETA_KEYS[box][0]][3]).max() > 0


def test_stokes_conductor_grads_match_jax(jax_nan_safe):
    """The glass box is `test_torch_ad_polarized_glass.py`'s."""
    stokes_grads_match_jax("conductor")


def test_jax_nan_sources_are_finite_in_the_port():
    """Each NaN source `jax_nan_safe` patches, at the input that makes it:
    jax.grad of the JAX package's function is NaN there, the port's
    gradient is finite (zero where the function is flat or constant)."""
    from mitsuba3_plt_tpu_torch.core import math as tm
    from mitsuba3_plt_tpu_torch.librender import fresnel as tf_

    def torch_grad(fn, *xs):
        xs = [torch.tensor(x, requires_grad=True) for x in xs]
        (g,) = torch.autograd.grad(fn(*xs), xs[-1:])
        return g.numpy()

    u = np.array([0.6, 0.0, 0.8], np.float32)
    # equal bases: the rotation angle's norm at zero
    assert np.isnan(jax.grad(lambda v: jm.unit_angle(u, v))(u)).any()
    assert np.isfinite(torch_grad(tm.unit_angle, u, u)).all()
    # the complex root on the positive real axis
    assert np.isnan(jax.grad(lambda x: jf.c_sqrt((x, 0.0 * x))[1])(
        np.float32(0.5)))
    assert np.isfinite(torch_grad(lambda x: tf_.c_sqrt(
        (x, 0.0 * x))[1], np.float32(0.5)))
    # total internal reflection at grazing incidence, and a zero index
    for cos_i, eta in ((np.float32(0.0), np.float32(0.8)),
                       (np.float32(-0.5), np.float32(0.0))):
        assert np.isnan(jax.grad(lambda e, c=cos_i: jf.fresnel_dielectric(
            c, e)[0])(eta))
        assert np.isfinite(torch_grad(
            lambda c, e: tf_.fresnel_dielectric(c, e)[0], cos_i, eta))


@pytest.mark.parametrize("key,idx", [("materials.eta_re", (3, 0)),
                                     ("materials.eta_im", (3, 1))])
def test_stokes_conductor_index_matches_finite_difference(key, idx):
    """The conductor's index changes values only (no direction, no lobe
    choice): its gradient against a float64 central difference of the
    port's render, same seed, within 1e-3."""
    _, scene, _, tsample = stokes_boxes("conductor")
    _, grads = ad.render_loss_grad(scene, tsample, torch.mean, [key],
                                   seed=0, spp=STOKES_SPP)
    params = ad.traverse(scene)

    def run(delta):
        p = params[key].clone()
        p[idx] += delta
        return float(ad.render_differentiable(
            params.update({key: p}), tsample, seed=0,
            spp=STOKES_SPP).double().mean())

    eps = 1e-2
    fd = (run(eps) - run(-eps)) / (2 * eps)
    got = float(grads[key][idx])
    assert abs(fd) > 0 and abs(got - fd) <= 1e-3 * abs(fd), (got, fd)


def test_diffuse_box_stokes_s0_gradient_is_the_scalar_paths():
    """On the all-diffuse box the Stokes path's S0 image is the scalar
    path tracer's, to the bit; so is its base-colour gradient,
    within float32 rounding of the Mueller products' other order."""
    scene = tpresets.cornell_box(BOX, BOX, device="cpu")
    key = ["materials.base_color"]
    stokes = StokesIntegrator(PolarizedPathIntegrator(STOKES_DEPTH,
                                                      STOKES_RR))
    _, gs = ad.render_loss_grad(scene, stokes.sample,
                                lambda img: img[..., 3:6].mean(), key,
                                seed=0, spp=STOKES_SPP)
    _, gp = ad.render_loss_grad(scene, PathIntegrator(STOKES_DEPTH,
                                                      STOKES_RR).sample,
                                torch.mean, key, seed=0, spp=STOKES_SPP)
    a, b = gs[key[0]].numpy(), gp[key[0]].numpy()
    assert np.abs(b).max() > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7 * np.abs(b).max())


# ---------------------------------------------------------------------------
# C-P1: the renders restore the caller's TF32 flags
# ---------------------------------------------------------------------------

def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = saved


def test_fp32_matmul_restores_the_flags(tf32_on):
    with fp32_matmul():
        assert flags() == (False, False)
    assert flags() == (True, True)
    with pytest.raises(ValueError):
        with fp32_matmul():
            raise ValueError
    assert flags() == (True, True)
    torch.backends.cudnn.allow_tf32 = False
    with fp32_matmul():
        assert flags() == (False, False)
    assert flags() == (True, False)


def test_renders_leave_the_callers_tf32_flags(tf32_on, monkeypatch):
    """Each render runs with both flags off and gives them back as set."""
    scene = tpresets.cornell_box(8, 8, device="cpu")
    inside = []
    path = PathIntegrator(2, 8)
    real = path.sample

    def sample(*a, **kw):
        inside.append(flags())
        return real(*a, **kw)

    img = render(scene, path, spp=1)
    assert flags() == (True, True) and torch.isfinite(img).all()
    key = ["materials.base_color"]
    ad.render_loss_grad(scene, sample, torch.mean, key, spp=1)
    assert flags() == (True, True)
    ad.render_grad(scene, sample, key, torch.ones((8, 8, 3)), spp=1)
    assert flags() == (True, True)
    ad.render_differentiable(scene, sample, spp=1)
    assert flags() == (True, True)
    prb = PRBIntegrator(2, 8)
    ad.render_loss_grad(scene, prb.sample, torch.mean, key, spp=1)
    assert flags() == (True, True)
    assert inside and all(f == (False, False) for f in inside)
    with pytest.raises(ValueError):
        render(scene, path, spp=1, pixel_order="spiral")
    assert flags() == (True, True)
