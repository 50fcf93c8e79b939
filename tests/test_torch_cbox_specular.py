"""The Cornell box's specular boxes and the environment branch through the
port's integrators against the JAX package (CPU), per lane: the path
tracer on the conductor, rough conductor and dielectric boxes and on the
grating scene (a constant emitter the escaped rays see), and the PLT
integrator on the diffuse, grating, conductor and dielectric boxes.

JAX intersects through its chunked classic scan on the CPU, the port
through the plain q loop. Where a ray inside a glass box meets its bottom
face and the floor under it at the same t, the two formulas may round
that tie to different faces; a lane may also take the other lobe where u1
lies within rounding of the dielectric's F. `per_lane` replays every
differing lane and names which of the two it met; no other difference is
allowed, and such lanes may be at most 1e-3 of the lanes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.librender.records import Ray as JRay
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.librender import bsdfs as tbsdfs
from mitsuba3_plt_tpu_torch.librender import fresnel as tfres
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene.scene import Scene
from test_torch_golden_specular import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-3, 1e-5
MAX_EXPLAINED = 1e-3



def _jax_radiance(jscene, integ, W, H, spp, seed=0):
    n = W * H * spp
    js = JSampler.create(seed, n).fork(0)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB)
    return np.asarray(jax.jit(
        lambda s, r: integ.sample(jscene, s, r, None, JRGB)[0])(js, jray))


def _port_radiance(tscene, integ, W, H, spp, monkeypatch, seed=0):
    """The port's per-lane radiance, with every closest-hit call's rays and
    answers and every dielectric sample's u1 and F recorded."""
    n = W * H * spp

    def run():
        ts = Sampler.create(seed, n, device="cpu").fork(0)
        tray, _ = sample_rays(tscene, ts, W, H, spp)
        return integ.sample(tscene, ts, tray)

    (got, valid), hits, lobes = recorded(run, monkeypatch)
    assert valid.all() and got.shape == (n, 3)
    return got.numpy(), hits, lobes


def recorded(run, monkeypatch):
    """(run(), hits, lobes): every closest-hit call's rays and answers and
    every dielectric sample's u1 and F while run() runs."""
    hits, lobes = [], []
    isect = Scene.ray_intersect

    def ray_intersect(self, ray):
        si = isect(self, ray)
        hits.append((ray.o.clone(), ray.d.clone(), ray.maxt.clone(),
                     si.prim_idx.clone(), si.t.clone()))
        return si

    sample = tbsdfs.Dielectric.sample

    def dielectric_sample(p, si, u1, u2, ndf, *pol):
        F = tfres.fresnel_dielectric(si.wi[..., 2], p["eta_re"][..., 0])[0]
        lobes.append((p["mtype"] == tbsdfs.BSDF_DIELECTRIC, u1, F))
        return sample(p, si, u1, u2, ndf, *pol)

    monkeypatch.setattr(Scene, "ray_intersect", ray_intersect)
    monkeypatch.setattr(tbsdfs.Dielectric, "sample",
                        staticmethod(dielectric_sample))
    try:
        out = run()
    finally:
        monkeypatch.undo()
    return out, hits, lobes


def _explain(jscene, lanes, hits, lobes):
    """{lane: reason} for the lanes given: "tie" where a bounce's closest
    hit, replayed by the JAX package on the port's own ray, is another
    face at the same t (rtol 1e-5), "lobe" where u1 lies within 1e-6 of
    the dielectric's F; lanes with neither are left out."""
    out = {}
    if not len(lanes):
        return out
    idx = torch.as_tensor(lanes)
    for o, d, maxt, prim, t in hits:
        sel = lambda x: jnp.asarray(x[idx].numpy())  # noqa: E731
        jsi = jscene.ray_intersect(JRay(o=sel(o), d=sel(d), maxt=sel(maxt)))
        jprim, jt = np.asarray(jsi.prim_idx), np.asarray(jsi.t)
        tp, pp = t[idx].numpy(), prim[idx].numpy()
        tie = (jprim != pp) & (jprim >= 0) & (pp >= 0) & np.isclose(
            jt, tp, rtol=1e-5, atol=0)
        for k in np.where(tie)[0]:
            out.setdefault(int(lanes[k]), "tie")
    for is_d, u1, F in lobes:
        near = (is_d & ((u1 - F).abs() <= 1e-6))[idx].numpy()
        for k in np.where(near)[0]:
            out.setdefault(int(lanes[k]), "lobe")
    return out


def per_lane(jscene, tscene, jinteg, tinteg, W, H, spp, monkeypatch):
    """Radiance of every lane, port against JAX at rtol 1e-3 / atol 1e-5,
    but for lanes `_explain` names, at most MAX_EXPLAINED of them."""
    want = _jax_radiance(jscene, jinteg, W, H, spp)
    got, hits, lobes = _port_radiance(tscene, tinteg, W, H, spp,
                                      monkeypatch)
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    bad = np.where(~close)[0]
    why = _explain(jscene, bad, hits, lobes)
    print(f"per-lane agreement {close.mean():.6f}; differing lanes "
          f"{len(bad)} ({len(bad) / close.size:.6f}): {why}")
    assert set(why) == set(bad.tolist()), sorted(set(bad) - set(why))
    assert len(bad) <= MAX_EXPLAINED * close.size
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)
    return got, want


@pytest.mark.parametrize("max_depth,rr_depth", [(4, 9), (5, 2)])
@pytest.mark.parametrize("box_material", ["conductor", "roughconductor",
                                          "dielectric"])
def test_cbox_box_path_radiance_per_lane_matches_jax(box_material, max_depth,
                                                     rr_depth, monkeypatch):
    W = H = 16
    jscene = jpresets.cornell_box(W, H, box_material=box_material)[0]
    tscene = tpresets.cornell_box(W, H, box_material=box_material,
                                  device="cpu")
    got, want = per_lane(jscene, tscene,
                         JPath(max_depth=max_depth, rr_depth=rr_depth),
                         PathIntegrator(max_depth=max_depth,
                                        rr_depth=rr_depth),
                         W, H, 4, monkeypatch)
    assert (want > 0).any(-1).mean() > 0.5
    assert (want > 1.0).any(-1).any()


@pytest.mark.parametrize("max_depth,rr_depth", [(4, 9), (5, 2)])
def test_grating_scene_path_radiance_per_lane_matches_jax(
        max_depth, rr_depth, monkeypatch):
    """The grating scene under the path tracer: the slab's classic BSDF is
    zero, so its light is the directional NEE on the floor and the
    environment, by NEE and by the escaped rays."""
    W = H = 16
    jscene = jpresets.grating_scene(W, H)[0]
    tscene = tpresets.grating_scene(W, H, device="cpu")
    got, want = per_lane(jscene, tscene,
                         JPath(max_depth=max_depth, rr_depth=rr_depth),
                         PathIntegrator(max_depth=max_depth,
                                        rr_depth=rr_depth),
                         W, H, 4, monkeypatch)
    assert tscene.env_emitter == 1
    assert (want > 0).any(-1).mean() > 0.05  # the floor around the slab


@pytest.mark.parametrize("box_material", ["diffuse", "grating", "conductor",
                                          "dielectric"])
def test_cbox_plt_radiance_per_lane_matches_jax(box_material, monkeypatch):
    """The PLT integrator on the Cornell box: its emissive term meets an
    area light, the grating box runs the wave sample and eval at half = 2,
    the specular boxes their replay weights."""
    W = H = 8
    jscene = jpresets.cornell_box(W, H, box_material=box_material)[0]
    tscene = tpresets.cornell_box(W, H, box_material=box_material,
                                  device="cpu")
    got, want = per_lane(jscene, tscene, JPLT(max_depth=4, rr_depth=9),
                         PLTIntegrator(max_depth=4, rr_depth=9), W, H, 4,
                         monkeypatch)
    assert (want > 1.0).any(-1).any()  # lanes that see the light
    if box_material == "grating":
        assert tscene.materials.grt_static == (2, 1)
