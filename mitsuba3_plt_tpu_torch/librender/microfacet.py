"""Microfacet distributions (GGX / Beckmann), Smith shadowing and
visible-normal sampling, anisotropic (alpha_u, alpha_v).

GGX VNDF sampling follows Heitz 2018; Beckmann follows Heitz & d'Eon 2014
with the erf-domain Newton inversion (three iterations)."""
from __future__ import annotations

import torch

from ..core import frame as fr
from ..core import math as m

GGX = 0
BECKMANN = 1


def ndf_eval(mu, alpha_u, alpha_v, mtype: int):
    """D(m) for the local microfacet normal mu [..., 3]."""
    ct2 = mu[..., 2] * mu[..., 2]
    cos4 = ct2 * ct2
    inv_ct = 1.0 / torch.clamp_min(torch.abs(mu[..., 2]), 1e-12)
    su = (-mu[..., 0] * inv_ct) / alpha_u
    sv = (-mu[..., 1] * inv_ct) / alpha_v
    s2 = su * su + sv * sv
    if mtype == BECKMANN:
        d = torch.exp(-s2) / (m.Pi * alpha_u * alpha_v
                              * torch.clamp_min(cos4, 1e-20))
    else:
        tmp = 1.0 + s2
        d = 1.0 / (m.Pi * alpha_u * alpha_v * tmp * tmp
                   * torch.clamp_min(cos4, 1e-20))
    return torch.where(mu[..., 2] > 0, d, 0.0)


def smith_g1(v, mu, alpha_u, alpha_v, mtype: int):
    """Monodirectional Smith shadowing G1(v, m)."""
    xy_alpha_2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
    tan_theta_alpha_2 = xy_alpha_2 / torch.clamp_min(v[..., 2] * v[..., 2],
                                                     1e-20)
    if mtype == BECKMANN:
        a = m.safe_rsqrt(tan_theta_alpha_2)
        a2 = a * a
        approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
        # the rational fit overshoots 1 slightly near a = 1.6: clamp
        g = torch.clamp_max(torch.where(a >= 1.6, 1.0, approx), 1.0)
    else:
        g = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
    g = torch.where(xy_alpha_2 == 0.0, 1.0, g)
    backfacing = fr.dot(v, mu) * v[..., 2] <= 0.0
    return torch.where(backfacing, 0.0, g)


def g_smith(wi, wo, mu, alpha_u, alpha_v, mtype: int):
    return (smith_g1(wi, mu, alpha_u, alpha_v, mtype)
            * smith_g1(wo, mu, alpha_u, alpha_v, mtype))


def pdf_vndf(wi, mu, alpha_u, alpha_v, mtype: int):
    """Visible-normal pdf: G1(wi) * |wi.m| * D(m) / |cos_theta_i|."""
    d = ndf_eval(mu, alpha_u, alpha_v, mtype)
    g1 = smith_g1(wi, mu, alpha_u, alpha_v, mtype)
    return (g1 * torch.abs(fr.dot(wi, mu)) * d
            / torch.clamp_min(torch.abs(wi[..., 2]), 1e-12))


def _stretch(wi, alpha_u, alpha_v):
    return fr.normalize(torch.stack(
        [alpha_u * wi[..., 0], alpha_v * wi[..., 1], wi[..., 2]], dim=-1
    ))


def sample_vndf_ggx(wi, u, alpha_u, alpha_v):
    """wi in the upper hemisphere (the caller flips). Returns (m, pdf)."""
    vh = _stretch(wi, alpha_u, alpha_v)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = m.safe_rsqrt(lensq)
    big = (lensq > 1e-12)[..., None]
    t1 = torch.where(
        big,
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], device=wi.device),
    )
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * m.Pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    mvec = fr.normalize(torch.stack(
        [alpha_u * nh[..., 0], alpha_v * nh[..., 1],
         torch.clamp_min(nh[..., 2], 1e-6)], dim=-1
    ))
    return mvec, pdf_vndf(wi, mvec, alpha_u, alpha_v, GGX)


def sample_vndf_beckmann(wi, u, alpha_u, alpha_v):
    """wi in the upper hemisphere (the caller flips). Returns (m, pdf)."""
    wi_p = _stretch(wi, alpha_u, alpha_v)
    sin2d = wi_p[..., 0] ** 2 + wi_p[..., 1] ** 2
    inv_l = m.safe_rsqrt(sin2d)
    near_n = sin2d < 1e-14
    cos_phi = torch.where(near_n, 1.0, wi_p[..., 0] * inv_l)
    sin_phi = torch.where(near_n, 0.0, wi_p[..., 1] * inv_l)
    ct = torch.clamp(wi_p[..., 2], 1e-6, 1.0)

    tan_t = m.safe_sqrt(1.0 - ct * ct) / ct
    cot_t = 1.0 / torch.clamp_min(tan_t, 1e-12)
    maxval = torch.erf(torch.clamp_max(cot_t, 6.0))
    ux = torch.clamp(u[..., 0], 1e-6, 1.0 - 1e-6)
    uy = torch.clamp(u[..., 1], 1e-6, 1.0 - 1e-6)
    inv_sqrt_pi = 0.5641895835477563
    x = maxval - (maxval + 1.0) * torch.erf(torch.sqrt(-torch.log(ux)))
    ux = ux * (1.0 + maxval + inv_sqrt_pi * tan_t * torch.exp(-(cot_t * cot_t)))
    for _ in range(3):
        x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
        slope = torch.erfinv(x)
        value = 1.0 + x + inv_sqrt_pi * tan_t * torch.exp(-(slope * slope)) - ux
        deriv = 1.0 - slope * tan_t
        x = x - value / torch.where(
            torch.abs(deriv) > 1e-6, deriv,
            torch.where(deriv >= 0, 1e-6, -1e-6),
        )
    x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
    slope_x = torch.erfinv(x)
    slope_y = torch.erfinv(2.0 * uy - 1.0)
    sx = (cos_phi * slope_x - sin_phi * slope_y) * alpha_u
    sy = (sin_phi * slope_x + cos_phi * slope_y) * alpha_v
    mvec = fr.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1))
    return mvec, pdf_vndf(wi, mvec, alpha_u, alpha_v, BECKMANN)


def sample_vndf(wi, u, alpha_u, alpha_v, mtype: int):
    if mtype == BECKMANN:
        return sample_vndf_beckmann(wi, u, alpha_u, alpha_v)
    return sample_vndf_ggx(wi, u, alpha_u, alpha_v)
