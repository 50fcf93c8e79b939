"""Classic BSDFs (diffuse, smooth and rough conductor, smooth dielectric)
and their masked dispatch.

Each implementation works on per-lane parameter dicts in the local shading
frame (z up, wi and wo pointing away from the surface). `sample` returns
(BSDFSample, weight, ok) with weight = f cos / pdf; a delta lobe's eval
and pdf are zero. Values are radiance transport: unpolarized [N, C], or,
with `pol` (a polarized config), Mueller matrices [4, 4, N, C] in the
local implicit Stokes bases, light arriving along -wo and leaving along
wi (`to_world_mueller` turns them to world bases). Colours are constant
RGB (textured materials are refused when the scene is built)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr
from ..core import math as m
from ..core import warp
from . import fresnel as fres
from . import microfacet as mf
from . import mueller as mu
from .bsdf import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                   BSDF_ROUGH_CONDUCTOR, BSDFFlags, MaterialTable)
from .records import BSDFSample


def mul_value(a, b):
    """Multiply a value ([N, C] or Mueller [4, 4, N, C]) by an unpolarized
    [N, C] factor."""
    return a * b


def zeros_value(n, n_channels, device, pol=False):
    shape = (4, 4, n, n_channels) if pol else (n, n_channels)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def where_value(mask, a, b):
    """Per lane: a where mask [N], else b (values [..., N, C])."""
    return torch.where(mask[:, None], a, b)


def depolarized(value, pol):
    """An unpolarized [N, C] value in the configured representation."""
    return mu.depolarizer(value) if pol else value


def _z_axis(v):
    return torch.tensor([0.0, 0.0, 1.0], device=v.device).expand(v.shape)


def _change_bases(R, M):
    """R_out @ M @ R_in^T for the rotators R [4, 4, 2, N] of the in (0) and
    out (1) directions, each computed once for both."""
    return mu.matmul(R[:, :, 1, :, None],
                     mu.matmul(M, mu.transpose(R[:, :, 0])[..., None]))


def _spec_reflect_mueller(wo_hat, wi_hat, M, normal):
    """A specular Mueller M [4, 4, N, C'], whose s-axis is normal x -wo_hat
    on the way in and normal x wi_hat on the way out, in the local
    implicit bases: R_out @ M @ R_in^T. Where |normal x -wo_hat|^2 <
    1e-12 (normal incidence) both axes are [1, 0, 0]."""
    fwd = torch.stack([-wo_hat, wi_hat])  # [2, N, 3]: in, out
    s_axis = fr.cross(normal, fwd)
    degenerate = (fr.squared_norm(s_axis[0]) < 1e-12)[:, None]
    fallback = torch.tensor([1.0, 0.0, 0.0], device=wo_hat.device)
    s_axis = torch.where(degenerate, fallback, fr.normalize(s_axis))
    return _change_bases(
        mu.rotate_stokes_basis(fwd, s_axis, mu.stokes_basis(fwd)), M)


def to_world_mueller(si, M, in_forward_local, out_forward_local):
    """A Mueller [4, 4, N, C] in the local implicit bases of its in and out
    directions, turned to the world implicit bases of those directions."""
    local = torch.stack([in_forward_local, out_forward_local])
    fwd_w = si.to_world(local)
    return _change_bases(mu.rotate_stokes_basis(
        fwd_w, si.to_world(mu.stokes_basis(local)), mu.stokes_basis(fwd_w)),
        M)


def _conductor_mueller(p, wo_hat, wi_hat, normal):
    """The conductor's Fresnel Mueller about normal, times the specular
    reflectance: [4, 4, N, C]."""
    M = mu.specular_reflection_conductor(
        fr.dot(wo_hat, normal)[..., None], p["eta_re"], p["eta_im"])
    return mul_value(_spec_reflect_mueller(wo_hat, wi_hat, M, normal),
                     p["base_color"])


def _sample_record(wo, pdf, flags):
    n = wo.shape[0]
    return BSDFSample(
        wo=wo, pdf=pdf,
        sampled_type=torch.full((n,), flags, dtype=torch.int64,
                                device=wo.device),
        eta=torch.ones((n,), device=wo.device),
    )


class Diffuse:
    @staticmethod
    def sample(p, si, u1, u2, ndf, pol=False):
        active = fr.cos_theta(si.wi) > 0
        wo = warp.square_to_cosine_hemisphere(u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        ok = active & (pdf > 0)
        weight = where_value(ok, depolarized(p["base_color"], pol), 0.0)
        return _sample_record(wo, pdf, BSDFFlags.DiffuseReflection), weight, ok

    @staticmethod
    def eval(p, si, wo, ndf, pol=False):
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        val = p["base_color"] * (
            m.InvPi * torch.clamp_min(fr.cos_theta(wo), 0.0))[..., None]
        return where_value(active, depolarized(val, pol), 0.0)

    @staticmethod
    def pdf(p, si, wo, ndf):
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        return torch.where(active, warp.square_to_cosine_hemisphere_pdf(wo),
                           0.0)


class RoughConductor:
    @staticmethod
    def fresnel_value(p, si, wo, mvec, pol=False):
        """Conductor Fresnel at the microfacet normal mvec times the
        specular reflectance: [N, C], or with `pol` the Mueller of the
        reflection wo -> wi about mvec [4, 4, N, C]."""
        if pol:
            return _conductor_mueller(p, wo, si.wi, mvec)
        ct = fr.dot(si.wi, mvec)
        F = fres.fresnel_conductor(ct[..., None], p["eta_re"], p["eta_im"])
        return p["base_color"] * F

    @staticmethod
    def sample(p, si, u1, u2, ndf, pol=False):
        cos_i = fr.cos_theta(si.wi)
        au, av = p["alpha"][..., 0], p["alpha"][..., 1]
        mvec, mpdf = mf.sample_vndf(
            torch.where((cos_i < 0)[..., None], -si.wi, si.wi), u2, au, av,
            ndf)
        wo = fr.reflect_n(si.wi, mvec)
        pdf = mpdf / torch.clamp_min(4.0 * torch.abs(fr.dot(wo, mvec)), 1e-12)
        ok = (cos_i > 0) & (fr.cos_theta(wo) > 0) & (mpdf > 0)
        # VNDF weight: F * G2 / G1
        G = mf.g_smith(si.wi, wo, mvec, au, av, ndf)
        G1 = mf.smith_g1(si.wi, mvec, au, av, ndf)
        w_scalar = G / torch.clamp_min(G1, 1e-12)
        weight = mul_value(RoughConductor.fresnel_value(p, si, wo, mvec, pol),
                           w_scalar[..., None])
        return (_sample_record(wo, pdf, BSDFFlags.GlossyReflection),
                where_value(ok, weight, 0.0), ok)

    @staticmethod
    def eval(p, si, wo, ndf, pol=False):
        cos_i = fr.cos_theta(si.wi)
        active = (cos_i > 0) & (fr.cos_theta(wo) > 0)
        au, av = p["alpha"][..., 0], p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        D = mf.ndf_eval(h, au, av, ndf)
        G = mf.g_smith(si.wi, wo, h, au, av, ndf)
        scalar = D * G / torch.clamp_min(4.0 * cos_i, 1e-12)
        val = mul_value(RoughConductor.fresnel_value(p, si, wo, h, pol),
                        scalar[..., None])
        return where_value(active & (D > 0), val, 0.0)

    @staticmethod
    def pdf(p, si, wo, ndf):
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        au, av = p["alpha"][..., 0], p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        mpdf = mf.pdf_vndf(si.wi, h, au, av, ndf)
        pdf = mpdf / torch.clamp_min(4.0 * torch.abs(fr.dot(wo, h)), 1e-12)
        return torch.where(active, pdf, 0.0)


class _Delta:
    """A delta lobe: nothing to evaluate, zero density."""

    @staticmethod
    def eval(p, si, wo, ndf, pol=False):
        return zeros_value(si.wi.shape[0], p["base_color"].shape[-1],
                           si.wi.device, pol)

    @staticmethod
    def pdf(p, si, wo, ndf):
        return torch.zeros(si.wi.shape[0], device=si.wi.device)


class Conductor(_Delta):
    @staticmethod
    def sample(p, si, u1, u2, ndf, pol=False):
        """Mirror reflection weighted by the specular reflectance times the
        conductor Fresnel at the incident angle (with `pol` its Mueller
        about the local z)."""
        cos_i = fr.cos_theta(si.wi)
        ok = cos_i > 0
        wo = fr.reflect(si.wi)
        if pol:
            value = _conductor_mueller(p, wo, si.wi, _z_axis(wo))
        else:
            value = p["base_color"] * fres.fresnel_conductor(
                cos_i[..., None], p["eta_re"], p["eta_im"])
        return (_sample_record(wo, torch.ones_like(cos_i),
                               BSDFFlags.DeltaReflection),
                where_value(ok, value, 0.0), ok)


def dielectric_mueller(eta, wo, wi, reflect, lobe_pdf):
    """The dielectric's Mueller [4, 4, N, 1] of the lobe chosen (reflect
    [N]) for light arriving along -wo, divided by that lobe's probability
    max(lobe_pdf, 1e-6), detached (the weight is f / pdf with the
    sampling density held fixed, as the JAX package's
    `bsdfs.py::Dielectric.sample`), in the local implicit bases."""
    ct = fr.cos_theta(wo)[..., None]
    M = mu.where(reflect,
                 mu.specular_reflection_dielectric(ct, eta[..., None]),
                 mu.specular_transmission(ct, eta[..., None]))
    M = mul_value(M, (1.0 / torch.clamp_min(lobe_pdf.detach(), 1e-6)
                      )[..., None])
    return _spec_reflect_mueller(wo, wi, M, _z_axis(wo))


class Dielectric(_Delta):
    @staticmethod
    def sample(p, si, u1, u2, ndf, pol=False):
        """Reflection where u1 <= F, else refraction (F = 1 under total
        internal reflection). The lobe's probability cancels F, so the
        weight is the reflectance or the transmittance, the latter times
        eta_ti^2 (radiance transport); a lane below the surface (cos_i <
        0) is inside the material and refracts out. With `pol` the weight
        is the chosen lobe's Mueller divided by its probability, times the
        same colour and eta_ti^2."""
        eta = p["eta_re"][..., 0]
        F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(
            fr.cos_theta(si.wi), eta)
        sel_reflect = u1 <= F
        wo = torch.where(sel_reflect[..., None], fr.reflect(si.wi),
                         fr.refract(si.wi, cos_t, eta_ti))
        bs = BSDFSample(
            wo=wo, pdf=torch.where(sel_reflect, F, 1.0 - F),
            sampled_type=torch.where(
                sel_reflect, BSDFFlags.DeltaReflection,
                BSDFFlags.DeltaTransmission).to(torch.int64),
            eta=torch.where(sel_reflect, 1.0, eta_it))
        if pol:
            value = mul_value(
                dielectric_mueller(eta, wo, si.wi, sel_reflect, bs.pdf),
                torch.where(sel_reflect[..., None], p["base_color"],
                            p["transmittance"]))
            factor = torch.where(sel_reflect, 1.0, eta_ti * eta_ti)
            value = mul_value(value, factor[..., None])
        else:
            value = torch.where(
                sel_reflect[..., None], p["base_color"],
                p["transmittance"] * (eta_ti * eta_ti)[..., None])
        return bs, value, torch.ones_like(sel_reflect)


# Types with a classic implementation. A roughgrating row has none here, as
# in the JAX package: its classic sample/eval/pdf are zero, and the wave
# path (plt/wbsdf.py) overrides its lanes.
IMPLS = {BSDF_DIFFUSE: Diffuse, BSDF_CONDUCTOR: Conductor,
         BSDF_ROUGH_CONDUCTOR: RoughConductor, BSDF_DIELECTRIC: Dielectric}

# types whose sample reads the 1D sample u1 (the lobe choice)
U1_TYPES = (BSDF_DIELECTRIC,)


def reads_u1(mat: MaterialTable) -> bool:
    """Whether `sample` on this table reads u1: a caller may pass None
    otherwise (and skip drawing it)."""
    return any(t in mat.present_types for t in U1_TYPES)


def flip_z(v):
    return v * torch.tensor([1.0, 1.0, -1.0], device=v.device)


def effective_si(p, si):
    """Twosided materials mirror the local frame for back-facing lanes."""
    flip = p["twosided"] & (si.wi[..., 2] < 0)
    wi = torch.where(flip[..., None], flip_z(si.wi), si.wi)
    return dataclasses.replace(si, wi=wi), flip


def sample(mat: MaterialTable, midx, si, u1, u2, n_channels, pol=False):
    """Dispatching classic sample over the present types:
    (BSDFSample, weight [N, C] or with `pol` [4, 4, N, C], ok [N]). u1 [N]
    (None where the table has no type in U1_TYPES) picks a lobe, u2 [N, 2]
    a direction. A twosided lane seen from below is evaluated in the
    mirrored frame and its Mueller value kept as it is, as the JAX package
    does."""
    n, dev = si.wi.shape[0], si.wi.device
    p = mat.gather(midx)
    si_eff, flip = effective_si(p, si)
    bs = BSDFSample.zeros(n, dev)
    val = zeros_value(n, n_channels, dev, pol)
    ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        mask = p["mtype"] == t
        bs_t, val_t, ok_t = impl.sample(p, si_eff, u1, u2, mat.mf_static,
                                        pol)
        bs = bs_t.where(mask, bs)
        val = where_value(mask, val_t, val)
        ok = torch.where(mask, ok_t, ok)
    wo = torch.where(flip[..., None], flip_z(bs.wo), bs.wo)
    return dataclasses.replace(bs, wo=wo), val, ok


def eval_(mat: MaterialTable, midx, si, wo, n_channels, pol=False):
    n, dev = si.wi.shape[0], si.wi.device
    p = mat.gather(midx)
    si_eff, flip = effective_si(p, si)
    wo_eff = torch.where(flip[..., None], flip_z(wo), wo)
    val = zeros_value(n, n_channels, dev, pol)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        val = where_value(p["mtype"] == t,
                          impl.eval(p, si_eff, wo_eff, mat.mf_static, pol),
                          val)
    return val


def pdf(mat: MaterialTable, midx, si, wo):
    p = mat.gather(midx)
    si_eff, flip = effective_si(p, si)
    wo_eff = torch.where(flip[..., None], flip_z(wo), wo)
    pd = torch.zeros(si.wi.shape[0], device=si.wi.device)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        pd = torch.where(p["mtype"] == t,
                         impl.pdf(p, si_eff, wo_eff, mat.mf_static), pd)
    return pd
