"""Unpolarized Fresnel terms: the dielectric's reflectance and refraction
terms, and the conductor's reflectance for a complex index
eta = eta_re + i * eta_im (the polarized Fresnel terms follow with the
polarized slice)."""
from __future__ import annotations

import torch

from ..core import math as m


def fresnel_conductor(cos_theta_i, eta_re, eta_im):
    ct2 = cos_theta_i * cos_theta_i
    st2 = torch.clamp_min(1.0 - ct2, 0.0)
    e2 = eta_re * eta_re - eta_im * eta_im
    ek2 = 2.0 * eta_re * eta_im
    t0 = e2 - st2
    a2pb2 = m.safe_sqrt(t0 * t0 + ek2 * ek2)
    t1 = a2pb2 + ct2
    a = m.safe_sqrt(0.5 * (a2pb2 + t0))
    t2 = 2.0 * a * torch.abs(cos_theta_i)
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-20)
    t3 = ct2 * a2pb2 + st2 * st2
    t4 = t2 * st2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-20)
    return 0.5 * (rs + rp)


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel for the relative index eta (inside
    over outside): (F, cos_theta_t, eta_it, eta_ti). cos_theta_t is signed
    (the hemisphere opposite cos_theta_i) and 0 under total internal
    reflection, where F is 1; an index-matched boundary (eta == 1) has
    F = 0."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    cos_theta_t_abs = m.safe_sqrt(cos_theta_t_sqr)

    a_s = (cos_theta_i_abs - eta_it * cos_theta_t_abs) / (
        cos_theta_i_abs + eta_it * cos_theta_t_abs)
    a_p = (eta_it * cos_theta_i_abs - cos_theta_t_abs) / (
        eta_it * cos_theta_i_abs + cos_theta_t_abs)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    tir = cos_theta_t_sqr <= 0.0
    F = torch.where(tir, 1.0, F)
    F = torch.where(eta == 1.0, 0.0, F)

    cos_theta_t = torch.where(tir, 0.0,
                              m.mulsign_neg(cos_theta_t_abs, cos_theta_i))
    return F, cos_theta_t, eta_it, eta_ti
