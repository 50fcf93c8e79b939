"""The port's wave BSDF and PLT integrator against the JAX package (CPU):
per-lane wbsdf_sample / eval / pdf / weight on identical hit records and
uniforms, per-lane radiance of a whole render, and the golden z-test."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.librender.bsdf import BSDFContext
from mitsuba3_plt_tpu.librender.records import SurfaceInteraction as JSI
from mitsuba3_plt_tpu.plt import wbsdf as jwb
from mitsuba3_plt_tpu.plt.coherence import Coherence as JCoherence
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import render, sample_rays
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.librender.records import SurfaceInteraction
from mitsuba3_plt_tpu_torch.plt import wbsdf as twb
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_golden_specular import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "grating_plt.npz")
N = 2048


def _dirs(rng, n, zmin):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.where(rng.random(n) < 0.9, np.abs(v[:, 2]) + zmin, v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    """Identical hit records in both packages: half diffuse, half grating
    lanes, random incident directions (10% from below), uv, uniforms and
    sampled wavelengths."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    n_ = _dirs(rng, N, 0.0)
    s_ = np.cross(n_, np.array([0.3, 1.0, 0.2], f32))
    s_ = (s_ / np.linalg.norm(s_, axis=-1, keepdims=True)).astype(f32)
    t_ = np.cross(n_, s_).astype(f32)
    rec = dict(
        valid=np.ones(N, bool), t=rng.uniform(0.5, 3, N).astype(f32),
        p=rng.uniform(-1, 1, (N, 3)).astype(f32), n=n_, sh_s=s_, sh_t=t_,
        sh_n=n_, uv=rng.uniform(0, 1, (N, 2)).astype(f32),
        wi=_dirs(rng, N, 0.1), prim_idx=np.zeros(N, np.int32),
        mat_idx=(np.arange(N) % 2).astype(np.int32),
        emitter_idx=np.full(N, -1, np.int32),
    )
    u2 = rng.uniform(0, 1, (N, 2)).astype(f32)
    lobe_u2 = rng.uniform(0, 1, (N, 2)).astype(f32)
    wl = rng.uniform(360, 680, (N, 3)).astype(f32)
    wo = _dirs(rng, N, 0.05)
    jscene, _ = jpresets.grating_scene(8, 8)
    tscene = tpresets.grating_scene(8, 8, device="cpu")
    jsi = JSI(**{k: jnp.asarray(v) for k, v in rec.items()},
              shape_idx=jnp.zeros(N, jnp.int32))
    tsi = SurfaceInteraction(**{
        k: torch.as_tensor(v).to(torch.int64) if k in ("mat_idx",
                                                       "emitter_idx")
        else torch.as_tensor(v) for k, v in rec.items()})
    return dict(jscene=jscene, tscene=tscene, jsi=jsi, tsi=tsi, u2=u2,
                lobe_u2=lobe_u2, wl=wl, wo=wo, midx=rec["mat_idx"])


def _jax_sd(L, lobe):
    n = N
    return jwb.PLTSamplePhaseData(
        bs=None, lobe=lobe, internal_frame=jnp.zeros((n, 3)),
        coherence=JCoherence.isotropic(jnp.zeros((n,)), jnp.zeros((n,))),
        sampling_wavelengths=jnp.asarray(L["wl"]))


def _torch_sd(L, lobe):
    return twb.PLTSamplePhaseData(bs=None, lobe=lobe,
                                  sampling_wavelengths=torch.as_tensor(L["wl"]))


def test_wbsdf_sample_matches_jax(lanes):
    L = lanes
    ctx = BSDFContext()
    jsd, jw, jok = jwb.wbsdf_sample(
        L["jscene"].materials, jnp.asarray(L["midx"]), L["jsi"],
        jnp.zeros(N), jnp.asarray(L["u2"]), jnp.asarray(L["lobe_u2"]), ctx,
        JRGB, jnp.asarray(L["wl"]))
    tsd, tw, tok = twb.wbsdf_sample(
        L["tscene"].materials, torch.as_tensor(L["midx"]).long(), L["tsi"],
        None, torch.as_tensor(L["u2"]), torch.as_tensor(L["lobe_u2"]),
        torch.as_tensor(L["wl"]))
    jok, tok = np.asarray(jok), tok.numpy()
    jlobe, tlobe = np.asarray(jsd.lobe), tsd.lobe.numpy()
    # the lobe pick may differ only where u lies within float rounding of a
    # lobe-CDF step (the two libraries' erf/erfinv differ in the last ulp)
    same = (tok == jok) & (tlobe == jlobe).all(-1)
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(tsd.bs.sampled_type.numpy()[same],
                                  np.asarray(jsd.bs.sampled_type)[same])
    live = same & jok
    assert live[L["midx"] == 1].mean() > 0.5  # grating lanes are exercised
    np.testing.assert_allclose(tsd.bs.wo.numpy()[live],
                               np.asarray(jsd.bs.wo)[live],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.minimum(tsd.bs.pdf.numpy()[live], 1e6),
                               np.minimum(np.asarray(jsd.bs.pdf)[live], 1e6),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(tw.numpy()[live], np.asarray(jw)[live],
                               rtol=2e-3, atol=1e-6)


def test_wbsdf_eval_pdf_weight_match_jax(lanes):
    L = lanes
    ctx = BSDFContext()
    lobe = np.zeros((N, 2), np.int32)
    jsd, tsd = _jax_sd(L, jnp.asarray(lobe)), _torch_sd(L, torch.as_tensor(lobe))
    jm, tmi = jnp.asarray(L["midx"]), torch.as_tensor(L["midx"]).long()
    jwo, two = jnp.asarray(L["wo"]), torch.as_tensor(L["wo"])
    mats_j, mats_t = L["jscene"].materials, L["tscene"].materials

    je = np.asarray(jwb.wbsdf_eval(mats_j, jm, L["jsi"], jwo, jsd, ctx, JRGB))
    te = twb.wbsdf_eval(mats_t, tmi, L["tsi"], two, tsd).numpy()
    # rtol 1e-3: the lobe sum's Bessel sweep switches to the Hankel form at
    # 0.75 M in the port and at 0.5 M in the JAX eval chain
    np.testing.assert_allclose(te, je, rtol=1e-3, atol=1e-6)
    assert (je[L["midx"] == 1] > 0).any()

    jp = np.asarray(jwb.wbsdf_pdf(mats_j, jm, L["jsi"], jwo, jsd, ctx, JRGB))
    tp = twb.wbsdf_pdf(mats_t, tmi, L["tsi"], two, tsd).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7)

    jw = np.asarray(jwb.wbsdf_weight(mats_j, jm, L["jsi"], jwo, jsd, ctx, JRGB))
    tw = twb.wbsdf_weight(mats_t, tmi, L["tsi"], two, tsd).numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-7)


def test_plt_radiance_per_lane_matches_jax():
    W = H = 16
    spp, seed = 4, 0
    n = W * H * spp
    jscene, _ = jpresets.grating_scene(W, H, coherence=1e3)
    js = JSampler.create(seed, n).fork(0)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    integ = JPLT(max_depth=3, rr_depth=9)
    want = np.asarray(jax.jit(
        lambda s, r: integ.sample(jscene, s, r, None, JRGB)[0])(js, jray))

    tscene = tpresets.grating_scene(W, H, coherence=1e3, device="cpu")
    ts = Sampler.create(seed, n, device="cpu").fork(0)
    tray, _ = sample_rays(tscene, ts, W, H, spp)
    got, valid = PLTIntegrator(max_depth=3, rr_depth=9).sample(tscene, ts, tray)
    got = got.numpy()
    assert valid.all() and got.shape == (n, 3)
    # >= 99% of lanes: libm ulp differences (and the q-form against the
    # classic intersection) can flip a lobe or roulette choice on a few
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-2)
    assert want.mean() > 0


def test_render_matches_golden_ztest():
    """The tests/test_golden.py grating_plt config through the port."""
    from scipy.stats import norm

    scene = tpresets.grating_scene(24, 24, coherence=1e3, device="cpu")
    integ = PLTIntegrator(max_depth=3, rr_depth=9)
    imgs = np.stack([render(scene, integ, seed=s, spp=12).numpy()
                     for s in range(4)])
    assert imgs.shape == (4, 24, 24, 3) and np.isfinite(imgs).all()
    ref = np.load(GOLDEN)
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    z = np.abs(mean - ref["mean"]) / np.sqrt((var + ref["var"]) / 4 + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    assert int((z > norm.isf(alpha / 2)).sum()) == 0, z.max()


def test_render_passes_and_film():
    scene = tpresets.grating_scene(8, 6, device="cpu")
    stats = {}
    img = render(scene, PLTIntegrator(max_depth=2, rr_depth=1), seed=3,
                 spp=6, spp_per_pass=2, stats=stats)
    assert img.shape == (6, 8, 3) and img.dtype == torch.float32
    assert stats["n_pass"] == 3 and stats["lanes_per_pass"] == 8 * 6 * 2
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("ndf", [0, 1])
def test_roughconductor_classic_bsdf_matches_jax(lanes, ndf):
    """The classic dispatch on a table whose row 0 is a rough conductor
    (bridged from the JAX table, so both packages read the same rows)."""
    import dataclasses

    from mitsuba3_plt_tpu.librender import bsdfs as jbsdfs
    from mitsuba3_plt_tpu_torch.librender import bsdfs as tbsdfs
    from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
    from test_torch_scene import jax_scene_arrays

    L = lanes
    jm = L["jscene"].materials
    jm = dataclasses.replace(
        jm, mtype=jm.mtype.at[0].set(3),
        alpha=jm.alpha.at[0].set(jnp.asarray([0.2, 0.35])),
        eta_re=jm.eta_re.at[0].set(jnp.asarray([0.2, 0.9, 1.1])),
        eta_im=jm.eta_im.at[0].set(jnp.asarray([3.9, 2.4, 2.1])),
        present_types=(3, 9), mf_static=ndf)
    arrays, static = jax_scene_arrays(dataclasses.replace(L["jscene"],
                                                          materials=jm))
    tm = scene_from_arrays(arrays, static, device="cpu").materials
    assert tm.present_types == (3, 9) and tm.mf_static == ndf
    ctx = BSDFContext()
    jmi, tmi = jnp.asarray(L["midx"]), torch.as_tensor(L["midx"]).long()
    jbs, jval, jok = jbsdfs.sample(jm, jmi, L["jsi"], jnp.zeros(N),
                                   jnp.asarray(L["u2"]), ctx, JRGB)
    tbs, tval, tok = tbsdfs.sample(tm, tmi, L["tsi"], None,
                                   torch.as_tensor(L["u2"]), 3)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert ok[L["midx"] == 0].mean() > 0.5
    np.testing.assert_allclose(tbs.wo.numpy()[ok], np.asarray(jbs.wo)[ok],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.minimum(tbs.pdf.numpy(), 1e6),
                               np.minimum(np.asarray(jbs.pdf), 1e6),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval),
                               rtol=1e-3, atol=1e-6)
    jwo, two = jnp.asarray(L["wo"]), torch.as_tensor(L["wo"])
    np.testing.assert_allclose(
        tbsdfs.eval_(tm, tmi, L["tsi"], two, 3).numpy(),
        np.asarray(jbsdfs.eval_(jm, jmi, L["jsi"], jwo, ctx, JRGB)),
        rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        tbsdfs.pdf(tm, tmi, L["tsi"], two).numpy(),
        np.asarray(jbsdfs.pdf(jm, jmi, L["jsi"], jwo, ctx, JRGB)),
        rtol=1e-4, atol=1e-6)
