"""Polarized PLT of the port against the JAX package (CPU), per lane: the
PLT integrator's `sample_stokes` (the Mueller prefix chain, the emissive
term alpha @ (e, 0, 0, 0) and the NEE term alpha @ (M_world @ (e / pdf,
0, 0, 0))) on the grating scene (a directional light and the
environment), on the Cornell box's grating box (an area light) and on its
glass and conductor boxes (the replay weights' Mueller branches), all four
Stokes components at the tolerances of test_torch_stokes.py; and the
polarized `sample`, which is S0 of `sample_stokes`."""
import numpy as np
import pytest

from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.integrators.stokes import StokesIntegrator as JStokes
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.config import RGB, RGB_POLARIZED
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.integrators.stokes import StokesIntegrator
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from test_torch_stokes import H, W, per_lane_stokes


def _scenes(name):
    if name == "grating_scene":
        return (jpresets.grating_scene(W, H)[0],
                tpresets.grating_scene(W, H, device="cpu"))
    return (jpresets.cornell_box(W, H, box_material=name)[0],
            tpresets.cornell_box(W, H, box_material=name, device="cpu"))


@pytest.mark.parametrize("name,max_depth,rr_depth", [
    ("grating_scene", 4, 9), ("grating_scene", 5, 2), ("grating", 4, 9),
    ("dielectric", 4, 9), ("conductor", 4, 2)])
def test_polarized_plt_stokes_per_lane_matches_jax(name, max_depth, rr_depth,
                                                   monkeypatch):
    jscene, tscene = _scenes(name)
    got, want = per_lane_stokes(jscene, tscene, JPLT(max_depth, rr_depth),
                                PLTIntegrator(max_depth, rr_depth),
                                monkeypatch)
    assert (want[:, 0] > 0).any(-1).mean() > 0.05
    if name in ("dielectric", "conductor"):
        assert (np.abs(want[:, 1:3]) > 1e-4).any()
    if name == "grating":
        assert tscene.materials.grt_static == (2, 1)


def test_stokes_integrator_over_plt_per_lane_matches_jax(monkeypatch):
    """stokes o plt (the reference fork's main-headless.py): the forward
    basis on the glass box under PLT."""
    jscene, tscene = _scenes("dielectric")
    per_lane_stokes(jscene, tscene, JStokes(JPLT(4, 9)),
                    StokesIntegrator(PLTIntegrator(4, 9)), monkeypatch,
                    stokes=True)


def test_polarized_plt_sample_is_s0():
    """The polarized `sample` renders S0 of `sample_stokes`, whose Stokes
    wrapper without the forward basis gives the same S0."""
    tscene = tpresets.grating_scene(W, H, device="cpu")
    integ = PLTIntegrator(4, 9)
    s0 = render(tscene, integ, seed=2, spp=4, cfg=RGB_POLARIZED).numpy()
    st = render(tscene, StokesIntegrator(integ, forward_basis=False), seed=2,
                spp=4).numpy()
    np.testing.assert_array_equal(s0, st[..., 3:6])
    assert np.isfinite(s0).all() and s0.mean() > 0
    with pytest.raises(ValueError):
        integ.sample_stokes(tscene, None, None, RGB)
