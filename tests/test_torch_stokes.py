"""Polarized transport of the port against the JAX package (CPU), per
lane: the Mueller path tracer's `sample_stokes` on the Cornell box's
glass, conductor and rough-conductor boxes, all four Stokes components;
`StokesIntegrator` with and without the forward basis and in the 16-channel
layout; the diffuse box's collapse to the scalar path tracer; the glass
box's degree of polarization; and the golden z-test of the port's render
against the JAX package's own `tests/golden/cbox_stokes.npz`.

Per lane every Stokes component is held at rtol 1e-3 / atol 1e-5. A lane
may differ where `per_lane` in test_torch_cbox_specular.py names a tie of
the glass bottom and the floor or a u1 within rounding of the
dielectric's F, at most 1e-3 of the lanes. A third kind, "cancel", goes
past the 1e-3 rule: a lane whose S0 and S3 agree may have S1 and S2
within 5e-4 S0 of JAX's where its path met a conductor (or grating)
reflection at which the float32 Fresnel Mueller, on the port's own
inputs, lies more than 1e-5 m00 from the same function in float64
(`fresnel_rounding`). Both packages take the same complex square root,
whose imaginary part comes from the cancellation of |z| and Re z, so an
input one rounding apart moves the Mueller by up to 2.5e-4 m00
(test_torch_mueller.py::test_conductor_mueller_vs_analytic). At most
5e-3 of the lanes (3 of 1,024 seen on the rough-conductor box, each with
a rounding of 3.6e-5 to 9.9e-5 m00)."""
import os

import numpy as np
import jax
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB_POLARIZED as JPOL
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.stokes import (
    PolarizedPathIntegrator as JPPI, StokesIntegrator as JStokes)
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch import ops
from mitsuba3_plt_tpu_torch.config import RGB, RGB_POLARIZED
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import render, sample_rays
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.stokes import (
    PolarizedPathIntegrator, StokesIntegrator, depolarizer_collapse_ok)
from mitsuba3_plt_tpu_torch.librender import bsdfs as tbsdfs
from mitsuba3_plt_tpu_torch.librender import mueller as tmu
from mitsuba3_plt_tpu_torch.librender.bsdf import (BSDF_CONDUCTOR,
                                                   BSDF_ROUGH_CONDUCTOR,
                                                   BSDF_ROUGH_GRATING)
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_cbox_specular import _explain, recorded
from test_torch_golden_specular import (one_torch_thread,  # noqa: F401
                                        ztest_failures)

RTOL, ATOL = 1e-3, 1e-5
MAX_EXPLAINED = 1e-3
CANCEL_REL, FRESNEL_ROUNDING, MAX_CANCEL = 5e-4, 1e-5, 5e-3
W = H = 16
SPP = 4


def stokes_of(values, n):
    """[n, 4, 3] Stokes of a StokesIntegrator's [n, 15] or [n, 16] values,
    its RGB (and alpha) checked against S0."""
    lead = values.shape[-1] - 12
    S = values[:, lead:].reshape(n, 4, 3)
    np.testing.assert_array_equal(values[:, :3], S[:, 0])
    if lead == 4:
        assert (values[:, 3] == 1).all()
    return S


def jax_stokes(jscene, jinteg, n, stokes=False):
    """The JAX package's per-lane Stokes [n, 4, 3] (its sample_stokes, or a
    StokesIntegrator's sample), seed 0, pass 0."""
    js = JSampler.create(0, n).fork(0)
    jray = j_sample_rays(jscene, js, W, H, SPP, JPOL)[0]
    if stokes:
        f = lambda s, r: jinteg.sample(jscene, s, r, None, JPOL)[0]  # noqa
        return stokes_of(np.asarray(jax.jit(f)(js, jray)), n)
    f = lambda s, r: jinteg.sample_stokes(jscene, s, r, None, JPOL)  # noqa
    return np.asarray(jax.jit(f)(js, jray))


def port_stokes(tscene, tinteg, n, monkeypatch, stokes=False):
    """The port's per-lane Stokes, its hits and dielectric lobes recorded,
    and the inputs of every conductor (or grating) Fresnel Mueller: the
    lanes of that type, the cosine of the reflection about its normal,
    and the complex eta."""
    mirrors = []
    conductor_mueller = tbsdfs._conductor_mueller

    def record_mirror(p, wo_hat, wi_hat, normal):
        is_c = ((p["mtype"] == BSDF_CONDUCTOR)
                | (p["mtype"] == BSDF_ROUGH_CONDUCTOR)
                | (p["mtype"] == BSDF_ROUGH_GRATING))
        mirrors.append((is_c, (wo_hat * normal).sum(-1), p["eta_re"],
                        p["eta_im"]))
        return conductor_mueller(p, wo_hat, wi_hat, normal)

    monkeypatch.setattr(tbsdfs, "_conductor_mueller", record_mirror)

    def run():
        ts = Sampler.create(0, n, device="cpu").fork(0)
        tray, _ = sample_rays(tscene, ts, W, H, SPP)
        if stokes:
            out, valid = tinteg.sample(tscene, ts, tray, RGB_POLARIZED)
            assert valid.all()
            return stokes_of(out.numpy(), n)
        return tinteg.sample_stokes(tscene, ts, tray, RGB_POLARIZED).numpy()

    out, hits, lobes = recorded(run, monkeypatch)
    return out, hits, lobes, mirrors


def fresnel_rounding(lanes, mirrors):
    """{lane: the largest rounding error, over the lane's conductor
    reflections and channels, of the float32 Fresnel Mueller on the port's
    own inputs (against the same function in float64), over m00}."""
    err = dict.fromkeys(map(int, lanes), 0.0)
    if not len(lanes):
        return err
    for is_c, cos, er, ei in mirrors:
        sel = np.asarray(lanes)[is_c[lanes].numpy()]
        if not len(sel):
            continue
        args = (cos[sel, None].expand(-1, er.shape[-1]), er[sel], ei[sel])
        M32, M64 = (tmu.to_lanes(tmu.specular_reflection_conductor(
            *(x.to(dt) for x in args))).double().numpy()
            for dt in (torch.float32, torch.float64))
        d = (np.abs(M32 - M64).max((-1, -2)) / M64[..., 0, 0]).max(-1)
        for lane, e in zip(sel, d):
            err[int(lane)] = max(err[int(lane)], float(e))
    return err


def per_lane_stokes(jscene, tscene, jinteg, tinteg, monkeypatch,
                    stokes=False):
    """Every lane's four Stokes components, port against JAX, as the module
    docstring states. Returns (got, want) [n, 4, 3]."""
    n = W * H * SPP
    want = jax_stokes(jscene, jinteg, n, stokes)
    got, hits, lobes, mirrors = port_stokes(tscene, tinteg, n, monkeypatch,
                                            stokes)
    assert got.shape == want.shape == (n, 4, 3)
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all((-1, -2))
    bad = np.where(~close)[0]
    why = _explain(jscene, bad, hits, lobes)
    s0 = np.abs(want[:, 0]).max(-1)
    cancel = (np.isclose(got[:, 0::3], want[:, 0::3], rtol=RTOL,
                         atol=ATOL).all((-1, -2))
              & (np.abs(got[:, 1:3] - want[:, 1:3]).max((-1, -2))
                 <= CANCEL_REL * s0))
    rounding = fresnel_rounding(bad, mirrors)
    for lane in bad:
        if (int(lane) not in why and cancel[lane]
                and rounding[int(lane)] > FRESNEL_ROUNDING):
            why[int(lane)] = "cancel"
    kinds = {k: sum(v == k for v in why.values())
             for k in ("tie", "lobe", "cancel")}
    print(f"per-lane agreement {close.mean():.6f}; differing lanes "
          f"{len(bad)}: {kinds} {why}; Fresnel rounding {rounding}")
    assert set(why) == set(bad.tolist()), sorted(set(bad) - set(why))
    assert kinds["tie"] + kinds["lobe"] <= MAX_EXPLAINED * n
    assert kinds["cancel"] <= MAX_CANCEL * n
    np.testing.assert_allclose(got[:, 0].mean(), want[:, 0].mean(),
                               rtol=1e-3)
    return got, want


@pytest.mark.parametrize("max_depth,rr_depth", [(4, 9), (5, 2)])
@pytest.mark.parametrize("box_material", ["dielectric", "conductor",
                                          "roughconductor"])
def test_polarized_path_stokes_per_lane_matches_jax(box_material, max_depth,
                                                    rr_depth, monkeypatch):
    jscene = jpresets.cornell_box(W, H, box_material=box_material)[0]
    tscene = tpresets.cornell_box(W, H, box_material=box_material,
                                  device="cpu")
    assert not depolarizer_collapse_ok(tscene)
    got, want = per_lane_stokes(
        jscene, tscene, JPPI(max_depth, rr_depth),
        PolarizedPathIntegrator(max_depth, rr_depth), monkeypatch)
    # the boxes polarize: linear (S1, S2) everywhere, circular (S3) after
    # a conductor's phase
    assert (np.abs(want[:, 1:3]) > 1e-4).any()
    if box_material != "dielectric":
        assert (np.abs(want[:, 3]) > 0).any()


@pytest.mark.parametrize("forward_basis,compat16", [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_stokes_integrator_per_lane_matches_jax(forward_basis, compat16,
                                                monkeypatch):
    """The 15- and 16-channel layouts and both bases on the glass box (the
    forward basis turns S1/S2 onto the sensor's x axis per lane)."""
    jscene = jpresets.cornell_box(W, H, box_material="dielectric")[0]
    tscene = tpresets.cornell_box(W, H, box_material="dielectric",
                                  device="cpu")
    kw = dict(forward_basis=forward_basis, compat16=compat16)
    got, _ = per_lane_stokes(jscene, tscene, JStokes(JPPI(4, 9), **kw),
                             StokesIntegrator(PolarizedPathIntegrator(4, 9),
                                              **kw),
                             monkeypatch, stokes=True)
    assert StokesIntegrator(**kw).n_out_channels == (16 if compat16 else 15)
    if not forward_basis:
        # the implicit basis: the inner integrator's Stokes unturned
        n = W * H * SPP
        inner = port_stokes(tscene, PolarizedPathIntegrator(4, 9), n,
                            monkeypatch)[0]
        np.testing.assert_array_equal(got, inner)


def test_render_sizes_the_film_from_the_integrator():
    """Without `n_out_channels` the film holds the integrator's own count:
    15, or 16 with compat16; the config's 3 for an integrator that states
    none. The count is not a setting of its own."""
    scene = tpresets.cornell_box(8, 8, box_material="dielectric",
                                 device="cpu")
    for compat16, ch in ((False, 15), (True, 16)):
        integ = StokesIntegrator(PolarizedPathIntegrator(3, 9),
                                 compat16=compat16)
        assert integ.n_out_channels == ch
        img = render(scene, integ, seed=0, spp=2)
        assert img.shape == (8, 8, ch) and bool(img.isfinite().all())
    assert render(scene, PathIntegrator(3, 9), seed=0, spp=2,
                  cfg=RGB_POLARIZED).shape == (8, 8, 3)
    with pytest.raises(TypeError):
        StokesIntegrator(n_out_channels=16)


def test_collapse_equals_the_scalar_path():
    """On the diffuse box the Stokes image is the scalar path tracer's: S0
    equal to PathIntegrator's render to the bit, S1-S3 exactly 0; the
    full Mueller transport (force_full) agrees at rtol 2e-5 / atol 1e-6
    (JAX tests/test_stokes.py's collapse test); a polarizing box does not
    collapse; and PathIntegrator under a polarized config returns S0."""
    scene = tpresets.cornell_box(16, 16, device="cpu")
    assert depolarizer_collapse_ok(scene)
    stokes = render(scene, StokesIntegrator(PolarizedPathIntegrator(4, 9)),
                    seed=0, spp=8).numpy()
    scalar = render(scene, PathIntegrator(4, 9), seed=0, spp=8).numpy()
    np.testing.assert_array_equal(stokes[..., 3:6], scalar)
    np.testing.assert_array_equal(stokes[..., :3], scalar)
    assert (stokes[..., 6:] == 0).all()
    full = render(scene, StokesIntegrator(PolarizedPathIntegrator(
        4, 9, force_full=True)), seed=0, spp=8).numpy()
    np.testing.assert_allclose(full, stokes, rtol=2e-5, atol=1e-6)
    s0 = render(scene, PathIntegrator(4, 9), seed=0, spp=8,
                cfg=RGB_POLARIZED).numpy()
    np.testing.assert_array_equal(s0, scalar)
    assert not depolarizer_collapse_ok(
        tpresets.cornell_box(8, 8, box_material="dielectric", device="cpu"))


def test_polarized_entry_points():
    """PathIntegrator under a polarized config is S0 of the Mueller path
    tracer, also on a polarizing box; sample_regen refuses the polarized
    config and render(regen=True) falls back to the fixed-depth pass;
    sample_stokes refuses an unpolarized config."""
    scene = tpresets.cornell_box(16, 16, box_material="dielectric",
                                 device="cpu")
    s0 = render(scene, PathIntegrator(4, 9), seed=1, spp=4,
                cfg=RGB_POLARIZED).numpy()
    st = render(scene, StokesIntegrator(PolarizedPathIntegrator(4, 9),
                                        forward_basis=False),
                seed=1, spp=4).numpy()
    np.testing.assert_array_equal(s0, st[..., 3:6])
    regen = render(scene, PathIntegrator(4, 9), seed=1, spp=4,
                   cfg=RGB_POLARIZED, regen=True).numpy()
    np.testing.assert_array_equal(regen, s0)
    with pytest.raises(NotImplementedError):
        PathIntegrator(4, 9).sample_regen(scene, 0, 16, 16, 1, RGB_POLARIZED,
                                          64)
    with pytest.raises(ValueError):
        PolarizedPathIntegrator().sample_stokes(scene, None, None, RGB)


def test_dielectric_polarizes():
    """JAX tests/test_stokes.py::test_dielectric_polarizes on the port: the
    glass box's degree of linear polarization reaches 0.1, and stays at
    most 1 + 1e-3 wherever S0 > 1e-3."""
    scene = tpresets.cornell_box(24, 24, box_material="dielectric",
                                 device="cpu")
    img = render(scene, StokesIntegrator(), seed=0, spp=24).numpy()
    s0 = img[..., 3:6]
    dop = np.sqrt(img[..., 6:9] ** 2 + img[..., 9:12] ** 2) / np.maximum(
        s0, 1e-6)
    print("max DOP", dop.max(), "where S0 > 1e-3", dop[s0 > 1e-3].max())
    assert float(dop.max()) > 0.1
    assert float(dop[s0 > 1e-3].max()) <= 1.0 + 1e-3


def test_port_render_matches_jax_golden_cbox_stokes():
    """The JAX package's golden `cbox_stokes` (tests/test_golden.py: the
    glass box at 24 x 24, StokesIntegrator() with its defaults, 15
    channels, 4 seeds x 12 spp): the port's CPU render of the same, per
    pixel and channel at the Sidak-corrected 1% level, 0 failing."""
    scene = tpresets.cornell_box(24, 24, box_material="dielectric",
                                 device="cpu")
    ops.reset_launch_counts()
    imgs = np.stack([render(scene, StokesIntegrator(), seed=s, spp=12).numpy() for s in range(4)])
    assert not any(ops.launch_counts().values())  # plain on the CPU
    assert imgs.shape == (4, 24, 24, 15) and np.isfinite(imgs).all()
    ref = np.load(os.path.join(os.path.dirname(__file__), "golden",
                               "cbox_stokes.npz"))
    n_fail, z_max, thresh = ztest_failures(imgs, ref)
    print("cbox_stokes z-test", n_fail, z_max, thresh)
    assert n_fail == 0, (n_fail, z_max, thresh)
    assert np.abs(imgs[..., 6:12]).max() > 1e-3  # it polarizes
