"""Classic BSDFs (diffuse, rough conductor) and their masked dispatch.

Each implementation works on per-lane parameter dicts in the local shading
frame (z up, wi and wo pointing away from the surface). `sample` returns
(BSDFSample, weight, ok) with weight = f cos / pdf. Values are unpolarized
[N, C]; colours are constant RGB (textured materials are refused when the
scene is built)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr
from ..core import math as m
from ..core import warp
from . import fresnel as fres
from . import microfacet as mf
from .bsdf import (BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDFFlags,
                   MaterialTable)
from .records import BSDFSample


def mul_value(a, b):
    """Multiply a value by an unpolarized [N, C] factor."""
    return a * b


def zeros_value(n, n_channels, device):
    return torch.zeros((n, n_channels), dtype=torch.float32, device=device)


def where_value(mask, a, b):
    return torch.where(mask[..., None], a, b)


def _sample_record(wo, pdf, flags):
    n = wo.shape[0]
    return BSDFSample(
        wo=wo, pdf=pdf,
        sampled_type=torch.full((n,), flags, dtype=torch.int64,
                                device=wo.device),
    )


class Diffuse:
    @staticmethod
    def sample(p, si, u2, ndf):
        active = fr.cos_theta(si.wi) > 0
        wo = warp.square_to_cosine_hemisphere(u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        ok = active & (pdf > 0)
        weight = where_value(ok, p["base_color"], 0.0)
        return _sample_record(wo, pdf, BSDFFlags.DiffuseReflection), weight, ok

    @staticmethod
    def eval(p, si, wo, ndf):
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        val = p["base_color"] * (
            m.InvPi * torch.clamp_min(fr.cos_theta(wo), 0.0))[..., None]
        return where_value(active, val, 0.0)

    @staticmethod
    def pdf(p, si, wo, ndf):
        active = (fr.cos_theta(si.wi) > 0) & (fr.cos_theta(wo) > 0)
        return torch.where(active, warp.square_to_cosine_hemisphere_pdf(wo),
                           0.0)


class RoughConductor:
    @staticmethod
    def fresnel_value(p, si, mvec):
        """Conductor Fresnel at the microfacet normal times the specular
        reflectance: [N, C]."""
        ct = fr.dot(si.wi, mvec)
        F = fres.fresnel_conductor(ct[..., None], p["eta_re"], p["eta_im"])
        return p["base_color"] * F

    @staticmethod
    def sample(p, si, u2, ndf):
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
        weight = mul_value(RoughConductor.fresnel_value(p, si, mvec),
                           w_scalar[..., None])
        return (_sample_record(wo, pdf, BSDFFlags.GlossyReflection),
                where_value(ok, weight, 0.0), ok)

    @staticmethod
    def eval(p, si, wo, ndf):
        cos_i = fr.cos_theta(si.wi)
        active = (cos_i > 0) & (fr.cos_theta(wo) > 0)
        au, av = p["alpha"][..., 0], p["alpha"][..., 1]
        h = fr.normalize(si.wi + wo)
        D = mf.ndf_eval(h, au, av, ndf)
        G = mf.g_smith(si.wi, wo, h, au, av, ndf)
        scalar = D * G / torch.clamp_min(4.0 * cos_i, 1e-12)
        val = mul_value(RoughConductor.fresnel_value(p, si, h),
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


# Types with a classic implementation. A roughgrating row has none here, as
# in the JAX package: its classic sample/eval/pdf are zero, and the wave
# path (plt/wbsdf.py) overrides its lanes.
IMPLS = {BSDF_DIFFUSE: Diffuse, BSDF_ROUGH_CONDUCTOR: RoughConductor}


def flip_z(v):
    return v * torch.tensor([1.0, 1.0, -1.0], device=v.device)


def effective_si(p, si):
    """Twosided materials mirror the local frame for back-facing lanes."""
    flip = p["twosided"] & (si.wi[..., 2] < 0)
    wi = torch.where(flip[..., None], flip_z(si.wi), si.wi)
    return dataclasses.replace(si, wi=wi), flip


def sample(mat: MaterialTable, midx, si, u2, n_channels):
    """Dispatching classic sample over the present types:
    (BSDFSample, weight [N, C], ok [N])."""
    n, dev = si.wi.shape[0], si.wi.device
    p = mat.gather(midx)
    si_eff, flip = effective_si(p, si)
    bs = BSDFSample.zeros(n, dev)
    val = zeros_value(n, n_channels, dev)
    ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        mask = p["mtype"] == t
        bs_t, val_t, ok_t = impl.sample(p, si_eff, u2, mat.mf_static)
        bs = bs_t.where(mask, bs)
        val = where_value(mask, val_t, val)
        ok = torch.where(mask, ok_t, ok)
    wo = torch.where(flip[..., None], flip_z(bs.wo), bs.wo)
    return dataclasses.replace(bs, wo=wo), val, ok


def eval_(mat: MaterialTable, midx, si, wo, n_channels):
    n, dev = si.wi.shape[0], si.wi.device
    p = mat.gather(midx)
    si_eff, flip = effective_si(p, si)
    wo_eff = torch.where(flip[..., None], flip_z(wo), wo)
    val = zeros_value(n, n_channels, dev)
    for t in mat.present_types:
        impl = IMPLS.get(t)
        if impl is None:
            continue
        val = where_value(p["mtype"] == t,
                          impl.eval(p, si_eff, wo_eff, mat.mf_static), val)
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
