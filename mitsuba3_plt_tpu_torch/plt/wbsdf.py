"""Wave-BSDF interface of the PLT integrator: masked dispatch of
wbsdf_sample / wbsdf_eval / wbsdf_pdf / wbsdf_weight over the material
table.

  * default (diffuse, conductors, dielectric): the classic sample/eval/pdf
    of `librender.bsdfs`;
  * replay weight: the albedo of a diffuse lane; the specular Fresnel value
    of a conductor lane; of a dielectric lane the reflectance or, where the
    recorded wo lies across the surface, the transmittance times eta_ti^2;
  * roughgrating: microfacet normal plus diffraction-lobe sampling
    (`ops.grating.grating_sample`), the lobe sum with angular-coherence
    falloff in eval (`ops.grating.grating_lobe_sum`), and the far-field
    alpha as pdf. Its replay weight is the classic eval/pdf ratio, which is
    zero because a roughgrating row has no classic implementation (the JAX
    package behaves the same way).

With `pol` (a polarized config) values are Mueller matrices [4, 4, N, C]
in the local implicit bases: the grating's lobe sum stays a scalar per
wavelength and only the conductor Fresnel around it becomes a Mueller
matrix; the replay weight is a diffuse lane's depolarized albedo, a
conductor's sample weight, and a dielectric's Mueller reflection or
transmission (replayed from wo's side) divided by its lobe's probability
F or 1 - F.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr
from ..core import math as m
from ..core import spectrum as spec
from ..librender import bsdfs
from ..librender import fresnel as fres
from ..librender.bsdf import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                              BSDF_ROUGH_GRATING, BSDFFlags, MaterialTable)
from ..librender.records import BSDFSample
from ..ops import grating as grating_ops
from . import grating as gr


@dataclasses.dataclass(frozen=True)
class PLTSamplePhaseData:
    """Sample-phase payload: the BSDF sample and the sampled lobe."""

    bs: BSDFSample
    lobe: torch.Tensor                  # [N, 2] int32
    sampling_wavelengths: torch.Tensor  # [N, C] nm


def sample_plt_wavelengths(u):
    """Sampling wavelengths in [CIE_MIN, CIE_MAX - 150] nm from u [N, C]."""
    return u * (spec.CIE_MAX - 150.0 - spec.CIE_MIN) + spec.CIE_MIN


def _make_grating(p, uv):
    return gr.Grating.create(
        inv_period=p["grt_inv_period"], q=p["grt_height"],
        lobes=p["grt_lobes"], gtype=p["grt_type"],
        multiplier=p["grt_multiplier"], uv=uv,
    )


def _half(mat: MaterialTable) -> int:
    return max(int(mat.grt_static[0]), 0)


class RoughGratingW:
    """Wave path of the roughgrating material."""

    @staticmethod
    def wbsdf_sample(p, si, u2, lobe_u2, sampling_wl, half, ndf, pol=False):
        """Microfacet normal, then a diffraction lobe around it;
        weight = F * G1 * lobe intensity. Returns (sd, weight, ok)."""
        n, dev = si.wi.shape[0], si.wi.device
        active = fr.cos_theta(si.wi) > 0
        g = _make_grating(p, si.uv)
        # the sample chain carries no gradient (detached sampling, as the
        # JAX package's kernel path): its inputs are detached explicitly,
        # since the kernel reads their storage and autograd would not see
        # the cut; the parameters differentiate through the eval
        out = grating_ops.grating_sample(
            *(x.detach() for x in (
                si.wi, u2, lobe_u2, sampling_wl[..., 0] * 1e-3, p["alpha"],
                g.grating_dir, g.inv_period, g.q, g.lobes,
                g.gtype & gr.TYPE_MASK, g.multiplier)),
            half=half, ndf=ndf,
        )
        ok = active & out["ok"]
        Fv = bsdfs.RoughConductor.fresnel_value(
            p, si, out["reflection_dir"], out["mvec"], pol)
        weight = bsdfs.where_value(
            ok, bsdfs.mul_value(Fv, out["w_g1_int"][..., None]), 0.0)
        bs = BSDFSample(
            wo=out["wo"], pdf=out["pdf"],
            sampled_type=torch.full((n,), BSDFFlags.GlossyReflection,
                                    dtype=torch.int64, device=dev),
            eta=torch.ones((n,), device=dev),
        )
        return (PLTSamplePhaseData(bs=bs, lobe=out["lobe"],
                                   sampling_wavelengths=sampling_wl),
                weight, ok)

    @staticmethod
    def wbsdf_eval(p, si, wo, wl_nm, half, separable, rgb_colour=None,
                   pol=False):
        """Lobe sum with angular-coherence falloff, then RGB colour of each
        sampled wavelength, conductor Fresnel at the half vector, masking."""
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        g = _make_grating(p, si.uv)
        a_cone = 2.0 * torch.sqrt(p["alpha"][..., 0] * p["alpha"][..., 1])
        per_wl = grating_ops.grating_lobe_sum(
            si.wi, wo, wl_nm, g.grating_dir, g.inv_period, g.q, g.lobes,
            g.gtype & gr.TYPE_MASK, g.multiplier, p["grt_coherence"], a_cone,
            half=half, separable=separable, n_channels=wl_nm.shape[-1],
        )
        # each sampled wavelength contributes its sRGB colour
        colour = (spec.xyz_to_srgb(spec.cie1931_xyz(wl_nm))
                  if rgb_colour is None else rgb_colour)  # [N, C, 3]
        result = sum(per_wl[:, k:k + 1] * torch.clamp_min(colour[:, k, :], 0.0)
                     for k in range(per_wl.shape[-1]))
        Fv = bsdfs.RoughConductor.fresnel_value(
            p, si, wo, fr.normalize(si.wi + wo), pol)
        return bsdfs.where_value(active, bsdfs.mul_value(Fv, result), 0.0)

    @staticmethod
    def wbsdf_pdf(p, si, wl_nm):
        """Far-field grating alpha at the hero wavelength."""
        wl_um = wl_nm[..., 0] * 1e-3
        k = 2.0 * m.Pi / torch.clamp_min(wl_um, 1e-6)
        return _make_grating(p, si.uv).alpha(si.wi, k)


def _gathered(mat, midx, si, wo=None):
    """(params, twosided-adjusted si and wo, flip) for a per-type override."""
    p = mat.gather(midx)
    si_eff, flip = bsdfs.effective_si(p, si)
    wo_eff = None if wo is None else torch.where(
        flip[..., None], bsdfs.flip_z(wo), wo)
    return p, si_eff, wo_eff, flip


def wbsdf_sample(mat: MaterialTable, midx, si, u1, u2, lobe_u2,
                 sampling_wl, pol=False):
    """Classic sample for every lane (u1 as `bsdfs.sample` takes it),
    grating lanes overridden by the wave path. Returns (PLTSamplePhaseData,
    weight [N, C] or with `pol` [4, 4, N, C], ok [N])."""
    n, dev = si.wi.shape[0], si.wi.device
    C = sampling_wl.shape[-1]
    bs, val, ok = bsdfs.sample(mat, midx, si, u1, u2, C, pol)
    sd = PLTSamplePhaseData(
        bs=bs, lobe=torch.zeros((n, 2), dtype=torch.int32, device=dev),
        sampling_wavelengths=sampling_wl,
    )
    if BSDF_ROUGH_GRATING in mat.present_types:
        p, si_eff, _, flip = _gathered(mat, midx, si)
        mask = p["mtype"] == BSDF_ROUGH_GRATING
        sd_g, val_g, ok_g = RoughGratingW.wbsdf_sample(
            p, si_eff, u2, lobe_u2, sampling_wl, _half(mat), mat.mf_static,
            pol)
        wo_g = torch.where(flip[..., None], bsdfs.flip_z(sd_g.bs.wo),
                           sd_g.bs.wo)
        bs_g = dataclasses.replace(sd_g.bs, wo=wo_g)
        sd = dataclasses.replace(
            sd, bs=bs_g.where(mask, sd.bs),
            lobe=torch.where(mask[..., None], sd_g.lobe, sd.lobe),
        )
        val = bsdfs.where_value(mask, val_g, val)
        ok = torch.where(mask, ok_g, ok)
    return sd, val, ok


def wbsdf_eval(mat: MaterialTable, midx, si, wo, sd: PLTSamplePhaseData,
               rgb_colour=None, pol=False):
    """Wave eval [N, C] (with `pol` [4, 4, N, C]): the grating lobe sum,
    the classic eval otherwise."""
    wl = sd.sampling_wavelengths
    val = bsdfs.eval_(mat, midx, si, wo, wl.shape[-1], pol)
    if BSDF_ROUGH_GRATING in mat.present_types:
        p, si_eff, wo_eff, _ = _gathered(mat, midx, si, wo)
        mask = p["mtype"] == BSDF_ROUGH_GRATING
        val_g = RoughGratingW.wbsdf_eval(
            p, si_eff, wo_eff, wl, _half(mat), bool(mat.grt_static[1]),
            rgb_colour, pol)
        val = bsdfs.where_value(mask, val_g, val)
    return val


def wbsdf_pdf(mat: MaterialTable, midx, si, wo, sd: PLTSamplePhaseData):
    pd = bsdfs.pdf(mat, midx, si, wo)
    if BSDF_ROUGH_GRATING in mat.present_types:
        p, si_eff, _, _ = _gathered(mat, midx, si)
        mask = p["mtype"] == BSDF_ROUGH_GRATING
        pd = torch.where(mask, RoughGratingW.wbsdf_pdf(
            p, si_eff, sd.sampling_wavelengths), pd)
    return pd


# types whose replay weight overrides eval / pdf
_WEIGHT_TYPES = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC)


def wbsdf_weight(mat: MaterialTable, midx, si, wo, sd: PLTSamplePhaseData,
                 pol=False):
    """Replay weight [N, C] (with `pol` [4, 4, N, C]): classic eval / pdf
    by default; the albedo for diffuse lanes (cos_i > 0); the conductor's
    sample weight (reflectance times Fresnel, cos_i > 0); for dielectric
    lanes the reflectance where wo lies on wi's side, else the
    transmittance times eta_ti^2, and with `pol` that colour times the
    Mueller of the lobe divided by the lobe's probability F or 1 - F."""
    C = sd.sampling_wavelengths.shape[-1]
    e_val = bsdfs.eval_(mat, midx, si, wo, C, pol)
    pd = bsdfs.pdf(mat, midx, si, wo)
    w = bsdfs.mul_value(e_val, torch.where(
        pd > 0, 1.0 / torch.clamp_min(pd, 1e-20), 0.0)[..., None])
    present = mat.present_types
    if not any(t in present for t in _WEIGHT_TYPES):
        return w
    p, si_eff, _, flip = _gathered(mat, midx, si)
    cos_i = fr.cos_theta(si_eff.wi)
    if BSDF_DIFFUSE in present:
        albedo = bsdfs.where_value(
            cos_i > 0, bsdfs.depolarized(p["base_color"], pol), 0.0)
        w = bsdfs.where_value(p["mtype"] == BSDF_DIFFUSE, albedo, w)
    if BSDF_CONDUCTOR in present:
        _, w_c, _ = bsdfs.Conductor.sample(p, si_eff, None, None, 0, pol)
        w = bsdfs.where_value(p["mtype"] == BSDF_CONDUCTOR, w_c, w)
    if BSDF_DIELECTRIC in present:
        wo_eff = torch.where(flip[..., None], bsdfs.flip_z(wo), wo)
        is_reflect = cos_i * fr.cos_theta(wo_eff) > 0
        eta = p["eta_re"][..., 0]
        F, _, _, eta_ti = fres.fresnel_dielectric(cos_i, eta)
        if pol:
            colour = torch.where(is_reflect[..., None], p["base_color"],
                                 p["transmittance"]) * torch.where(
                is_reflect, 1.0, eta_ti * eta_ti)[..., None]
            w_d = bsdfs.mul_value(bsdfs.dielectric_mueller(
                eta, wo_eff, si_eff.wi, is_reflect,
                torch.where(is_reflect, F, 1.0 - F)), colour)
        else:
            w_d = torch.where(
                is_reflect[..., None], p["base_color"],
                p["transmittance"] * (eta_ti * eta_ti)[..., None])
        w = bsdfs.where_value(p["mtype"] == BSDF_DIELECTRIC, w_d, w)
    return w
