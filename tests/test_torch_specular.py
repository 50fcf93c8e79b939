"""The specular materials and the environment of the port against the JAX
package (CPU), element-wise on identical inputs: the dielectric Fresnel
terms, the local-frame reflect and refract, the conductor's and the
dielectric's sample, eval and pdf on both hemispheres (u1 at, and an ulp
either side of, F included), the PLT replay weight of every box material,
the constant emitter's escape terms, and the Cornell box and furnace
presets' arrays against the bridged JAX scenes."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core import frame as jfr
from mitsuba3_plt_tpu.librender import bsdfs as jbsdfs
from mitsuba3_plt_tpu.librender import fresnel as jfres
from mitsuba3_plt_tpu.librender.bsdf import BSDFContext
from mitsuba3_plt_tpu.librender.records import SurfaceInteraction as JSI
from mitsuba3_plt_tpu.plt import wbsdf as jwb
from mitsuba3_plt_tpu.plt.coherence import Coherence as JCoherence
from mitsuba3_plt_tpu.scene import emitters as jem
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.core import frame as tfr
from mitsuba3_plt_tpu_torch.librender import bsdfs as tbsdfs
from mitsuba3_plt_tpu_torch.librender import fresnel as tfres
from mitsuba3_plt_tpu_torch.librender.bsdf import (BSDF_CONDUCTOR,
                                                   BSDF_DIELECTRIC, BSDFFlags)
from mitsuba3_plt_tpu_torch.librender.records import SurfaceInteraction
from mitsuba3_plt_tpu_torch.plt import wbsdf as twb
from mitsuba3_plt_tpu_torch.scene import emitters as tem
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from test_torch_cbox_specular import one_torch_thread  # noqa: F401
from test_torch_scene import _tensors, jax_scene_arrays

N = 4096
BOX = 3  # the Cornell box's material row of its two boxes


def _dirs(rng, n):
    """Unit directions on both hemispheres, a few grazing ones."""
    v = rng.normal(size=(n, 3))
    v[:8, 2] = 0.0
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _cos_cases(rng):
    """cos_theta_i on both sides, the normal and grazing incidence."""
    return np.concatenate([rng.uniform(-1, 1, N),
                           [0.0, -0.0, 1.0, -1.0, 1e-7, -1e-7]]).astype(
        np.float32)


@pytest.mark.parametrize("eta", [1.5046, 1.0 / 1.5046, 1.0, 2.4])
def test_fresnel_dielectric_matches_jax(eta):
    """F, the signed cos_theta_t, eta_it and eta_ti on every lane, total
    internal reflection (cos_i < 0 at eta > 1, or eta < 1 from outside)
    and the index-matched boundary included."""
    ct = _cos_cases(np.random.default_rng(11))
    e = np.full_like(ct, eta)
    want = jfres.fresnel_dielectric(jnp.asarray(ct), jnp.asarray(e))
    got = tfres.fresnel_dielectric(torch.as_tensor(ct), torch.as_tensor(e))
    for name, g, w in zip(("F", "cos_theta_t", "eta_it", "eta_ti"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    F, cos_t, eta_ti = got[0].numpy(), got[1].numpy(), got[3].numpy()
    tir = 1 - eta_ti * eta_ti * (1 - ct * ct) <= 0
    if eta == 1.0:
        assert (F == 0).all() and not tir[np.abs(ct) > 1e-3].any()
    else:
        assert (F[tir] == 1).all() and (cos_t[tir] == 0).all()
        inside = ct < 0 if eta > 1 else ct > 0
        assert tir[inside].any() and not tir[~inside & (ct != 0)].any()
    live = cos_t != 0
    assert (np.sign(cos_t[live]) == np.where(ct >= 0, -1, 1)[live]).all()


def test_reflect_refract_match_jax():
    rng = np.random.default_rng(12)
    wi = _dirs(rng, N)
    eta = rng.uniform(0.5, 2.5, N).astype(np.float32)
    jF, jct, _, jeti = jfres.fresnel_dielectric(jnp.asarray(wi[:, 2]),
                                                jnp.asarray(eta))
    tF, tct, _, teti = tfres.fresnel_dielectric(torch.as_tensor(wi[:, 2]),
                                                torch.as_tensor(eta))
    np.testing.assert_array_equal(tfr.reflect(torch.as_tensor(wi)).numpy(),
                                  np.asarray(jfr.reflect(jnp.asarray(wi))))
    got = tfr.refract(torch.as_tensor(wi), tct, teti).numpy()
    want = np.asarray(jfr.refract(jnp.asarray(wi), jct, jeti))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a refracted direction is a unit vector across the boundary
    live = np.asarray(jct) != 0
    np.testing.assert_allclose(np.linalg.norm(got[live], axis=-1), 1.0,
                               atol=1e-5)
    assert (got[live, 2] * wi[live, 2] <= 0).all()


def _scenes(box_material):
    """(JAX Cornell box, the port's bridged from it) at 8 x 8."""
    jscene = jpresets.cornell_box(8, 8, box_material=box_material)[0]
    return jscene, scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")


def _lanes(rng, n):
    """Identical hit records for both packages: every other lane on the box
    material, wi on both hemispheres."""
    f32 = np.float32
    n_ = _dirs(rng, n)
    s_ = np.cross(n_, np.array([0.3, 1.0, 0.2], f32))
    s_ = (s_ / np.linalg.norm(s_, axis=-1, keepdims=True)).astype(f32)
    t_ = np.cross(n_, s_).astype(f32)
    rec = dict(
        valid=np.ones(n, bool), t=rng.uniform(0.5, 3, n).astype(f32),
        p=rng.uniform(-1, 1, (n, 3)).astype(f32), n=n_, sh_s=s_, sh_t=t_,
        sh_n=n_, uv=rng.uniform(0, 1, (n, 2)).astype(f32),
        wi=_dirs(rng, n), prim_idx=np.zeros(n, np.int32),
        mat_idx=np.where(np.arange(n) % 2 == 0, BOX,
                         np.arange(n) % 3).astype(np.int32),
        emitter_idx=np.full(n, -1, np.int32),
    )
    jsi = JSI(**{k: jnp.asarray(v) for k, v in rec.items()},
              shape_idx=jnp.zeros(n, jnp.int32))
    tsi = SurfaceInteraction(**{
        k: torch.as_tensor(v).to(torch.int64)
        if k in ("mat_idx", "emitter_idx") else torch.as_tensor(v)
        for k, v in rec.items()})
    return jsi, tsi, rec["mat_idx"]


def _u1_at_F(rng, wi, eta):
    """u1 uniform on a quarter of each two lanes' pairs, at F, an ulp
    below and an ulp above it on the others (F by the JAX function; lane
    i's case is (i // 2) % 4, so the box lanes, every other one, take all
    four)."""
    F = np.asarray(jfres.fresnel_dielectric(jnp.asarray(wi[:, 2]),
                                            jnp.asarray(eta))[0])
    u1 = rng.random(wi.shape[0]).astype(np.float32)
    k = (np.arange(wi.shape[0]) // 2) % 4
    u1 = np.where(k == 1, F, u1)
    u1 = np.where(k == 2, np.nextafter(F, np.float32(-1)), u1)
    u1 = np.where(k == 3, np.nextafter(F, np.float32(2)), u1)
    return np.clip(u1, 0, np.nextafter(np.float32(1), np.float32(0))), F


@pytest.mark.parametrize("box_material", ["conductor", "dielectric"])
def test_specular_sample_eval_pdf_match_jax(box_material):
    """The classic dispatch on the box's table: sample on identical u1, u2
    and wi, then eval and pdf (zero: delta lobes) at random wo. On the
    dielectric the reflect/refract choice is equal on every lane but where
    u1 lies between the two packages' F, which may differ in the last
    ulps."""
    jscene, tscene = _scenes(box_material)
    jm, tm = jscene.materials, tscene.materials
    rng = np.random.default_rng(13)
    jsi, tsi, midx = _lanes(rng, N)
    eta = np.full(N, 1.5046, np.float32)
    u1, F = _u1_at_F(rng, np.asarray(jsi.wi), eta)
    u2 = rng.random((N, 2)).astype(np.float32)
    ctx = BSDFContext()
    jmi, tmi = jnp.asarray(midx), torch.as_tensor(midx).long()
    jbs, jval, jok = jbsdfs.sample(jm, jmi, jsi, jnp.asarray(u1),
                                   jnp.asarray(u2), ctx, JRGB)
    tbs, tval, tok = tbsdfs.sample(tm, tmi, tsi, torch.as_tensor(u1),
                                   torch.as_tensor(u2), 3)
    box = midx == BOX
    # the two F may differ in the last few ulps (XLA rounds the division
    # chain otherwise): a lane whose u1 lies between them may take the
    # other lobe
    tF = tfres.fresnel_dielectric(tsi.wi[:, 2], torch.as_tensor(eta))[0]
    tF = tF.numpy()
    np.testing.assert_allclose(tF, F, rtol=1e-6, atol=1e-8)
    tie = ((u1 >= np.minimum(tF, F)) & (u1 <= np.maximum(tF, F))
           & (tF != F) & box & (box_material == "dielectric"))
    same = (tbs.sampled_type.numpy() == np.asarray(jbs.sampled_type))
    print(f"u1 within rounding of F: {tie.mean():.6f} of lanes, "
          f"{(~same).mean():.6f} take the other lobe")
    assert same[~tie].all()
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tbs.wo.numpy()[same],
                               np.asarray(jbs.wo)[same], rtol=1e-5,
                               atol=1e-6)
    for field in ("pdf", "eta"):
        np.testing.assert_allclose(getattr(tbs, field).numpy()[same],
                                   np.asarray(getattr(jbs, field))[same],
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(tval.numpy()[same], np.asarray(jval)[same],
                               rtol=1e-5, atol=1e-6)
    st = tbs.sampled_type.numpy()[box]
    front = np.asarray(jsi.wi)[box, 2] > 0
    if box_material == "conductor":
        assert (st == BSDFFlags.DeltaReflection).all()
        assert (tok.numpy()[box] == front).all()
    else:
        # both lobes from both sides, the lanes at F reflect
        assert tok.numpy()[box].all()
        for side in (front, ~front):
            assert (st[side] == BSDFFlags.DeltaTransmission).any()
            assert (st[side] == BSDFFlags.DeltaReflection).any()
        at_F = box & ((np.arange(N) // 2) % 4 == 1) & (tF == F)
        assert at_F.sum() > N // 16
        assert (tbs.sampled_type.numpy()[at_F]
                == BSDFFlags.DeltaReflection).all()
        refr = box & (tbs.sampled_type.numpy() == BSDFFlags.DeltaTransmission)
        assert (tbs.eta.numpy()[refr] != 1).all()
    wo = _dirs(rng, N)
    jwo, two = jnp.asarray(wo), torch.as_tensor(wo)
    te = tbsdfs.eval_(tm, tmi, tsi, two, 3).numpy()
    np.testing.assert_allclose(
        te, np.asarray(jbsdfs.eval_(jm, jmi, jsi, jwo, ctx, JRGB)),
        rtol=1e-5, atol=1e-7)
    tp = tbsdfs.pdf(tm, tmi, tsi, two).numpy()
    np.testing.assert_allclose(
        tp, np.asarray(jbsdfs.pdf(jm, jmi, jsi, jwo, ctx, JRGB)),
        rtol=1e-5, atol=1e-7)
    assert (te[box] == 0).all() and (tp[box] == 0).all()


def test_u1_is_drawn_only_where_a_type_reads_it():
    """Only the dielectric reads u1: the other tables sample with None."""
    for m in ("diffuse", "conductor", "roughconductor", "grating"):
        assert not tbsdfs.reads_u1(_scenes(m)[1].materials), m
    assert tbsdfs.reads_u1(_scenes("dielectric")[1].materials)


@pytest.mark.parametrize("box_material", ["diffuse", "conductor",
                                          "roughconductor", "dielectric",
                                          "grating"])
def test_wbsdf_weight_matches_jax(box_material):
    """The PLT replay weight on identical hit records and wo: the albedo of
    diffuse lanes, the conductor's Fresnel value, the dielectric's
    reflectance or eta_ti^2 transmittance by wo's side, eval / pdf else."""
    jscene, tscene = _scenes(box_material)
    rng = np.random.default_rng(14)
    jsi, tsi, midx = _lanes(rng, N)
    wo = _dirs(rng, N)
    wl = rng.uniform(360, 680, (N, 3)).astype(np.float32)
    jsd = jwb.PLTSamplePhaseData(
        bs=None, lobe=jnp.zeros((N, 2), jnp.int32),
        internal_frame=jnp.zeros((N, 3)),
        coherence=JCoherence.isotropic(jnp.zeros((N,)), jnp.zeros((N,))),
        sampling_wavelengths=jnp.asarray(wl))
    tsd = twb.PLTSamplePhaseData(bs=None,
                                 lobe=torch.zeros((N, 2), dtype=torch.int32),
                                 sampling_wavelengths=torch.as_tensor(wl))
    want = np.asarray(jwb.wbsdf_weight(
        jscene.materials, jnp.asarray(midx), jsi, jnp.asarray(wo), jsd,
        BSDFContext(), JRGB))
    got = twb.wbsdf_weight(tscene.materials, torch.as_tensor(midx).long(),
                           tsi, torch.as_tensor(wo), tsd).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    box = midx == BOX
    if box_material in ("conductor", "dielectric"):
        assert (got[box] > 0).any(-1).mean() > 0.4
    if box_material == "dielectric":
        across = box & (np.asarray(jsi.wi)[:, 2] * wo[:, 2] < 0)
        assert not np.allclose(got[across], 1.0)  # eta_ti^2 scales them


def test_env_terms_match_jax():
    """env_value, escape_pdf and the environment emitter's index on the
    grating scene (a directional and a constant emitter) and the furnace."""
    rng = np.random.default_rng(15)
    d = _dirs(rng, 256)
    for jscene in (jpresets.grating_scene(8, 8)[0],
                   jpresets.furnace_scene(8, 8, radiance=2.5)[0]):
        tscene = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
        assert tscene.env_emitter == jscene.env_emitter >= 0
        assert tscene.env_emitter == jem.env_emitter_index(jscene.emitters)
        np.testing.assert_array_equal(
            tem.env_value(tscene.emitters, torch.as_tensor(d)).numpy(),
            np.asarray(jem.env_value(jscene.emitters, jscene.env_emitter,
                                     jnp.asarray(d), JRGB, None)))
        np.testing.assert_allclose(
            tem.escape_pdf(tscene.emitters, torch.as_tensor(d)).numpy(),
            np.asarray(jem.escape_pdf(jscene.emitters, jnp.asarray(d))),
            rtol=1e-7)
    cbox = tpresets.cornell_box(8, 8, device="cpu")
    assert cbox.env_emitter == -1
    assert (tem.escape_pdf(cbox.emitters, torch.as_tensor(d)) == 0).all()


def test_scene_derives_its_env_emitter():
    """The environment's index follows the scene's emitters, through
    dataclasses.replace too, and no caller sets it."""
    furnace = tpresets.furnace_scene(8, 8, device="cpu")
    cbox = tpresets.cornell_box(8, 8, device="cpu")
    assert dataclasses.replace(cbox, emitters=furnace.emitters
                               ).env_emitter == 0
    assert dataclasses.replace(furnace, sensor=cbox.sensor).env_emitter == 0
    assert dataclasses.replace(furnace, emitters=cbox.emitters
                               ).env_emitter == -1
    with pytest.raises(ValueError, match="env_emitter"):
        dataclasses.replace(furnace, env_emitter=-1)


def test_gather_reads_transmittance_only_with_a_dielectric():
    """Only a table with a dielectric row gathers the transmittance, so
    the other scenes' wavefronts gather what they did before."""
    diffuse = tpresets.cornell_box(8, 8, device="cpu").materials
    glass = tpresets.cornell_box(8, 8, box_material="dielectric",
                                 device="cpu").materials
    midx = torch.tensor([0, BOX, BOX, 1])
    assert "transmittance" not in diffuse.gather(midx)
    assert torch.equal(glass.gather(midx)["transmittance"],
                       glass.transmittance[midx])


def _assert_same_scene(port, bridged):
    a, b = _tensors(port), _tensors(bridged)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key
    assert port.env_emitter == bridged.env_emitter


@pytest.mark.parametrize("light_scale", [1.0, 0.0, 2.0])
@pytest.mark.parametrize("box_material", ["diffuse", "conductor",
                                          "roughconductor", "dielectric",
                                          "grating"])
def test_cbox_arrays_equal_bridged_jax_scene(box_material, light_scale):
    jscene = jpresets.cornell_box(8, 8, light_scale=light_scale,
                                  box_material=box_material)[0]
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    port = tpresets.cornell_box(8, 8, light_scale=light_scale,
                                box_material=box_material, device="cpu")
    _assert_same_scene(port, bridged)
    assert port.env_emitter == -1 and port.intersect_route() == "brute"
    if box_material == "dielectric":
        flags = int(port.materials.flags[BOX])
        assert port.materials.mtype[BOX] == BSDF_DIELECTRIC
        assert flags & BSDFFlags.NonSymmetric and not flags & BSDFFlags.Smooth
        assert not port.materials.twosided[BOX]
    if box_material == "conductor":
        assert port.materials.mtype[BOX] == BSDF_CONDUCTOR


@pytest.mark.parametrize("material", ["diffuse", "conductor",
                                      "roughconductor"])
def test_furnace_arrays_equal_bridged_jax_scene(material):
    jscene = jpresets.furnace_scene(8, 6, albedo=0.6, radiance=1.5,
                                    material=material)[0]
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    port = tpresets.furnace_scene(8, 6, albedo=0.6, radiance=1.5,
                                  material=material, device="cpu")
    _assert_same_scene(port, bridged)
    assert port.geo.n_faces == 1280 and port.intersect_route() == "brute"
    assert port.env_emitter == 0


def test_presets_refuse_unknown_materials():
    """The JAX presets take any other name for their diffuse default; the
    port's raise instead (ROADMAP §C)."""
    with pytest.raises(ValueError, match="box_material"):
        tpresets.cornell_box(8, 8, box_material="gold", device="cpu")
    with pytest.raises(ValueError, match="material"):
        tpresets.furnace_scene(8, 8, material="plastic", device="cpu")
    a = tpresets.cornell_box_arrays(8, 8)[0]
    b = tpresets.cornell_box_arrays(8, 8, box_material="diffuse")[0]
    assert all(np.array_equal(a[k], b[k]) for k in a)
