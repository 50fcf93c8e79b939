"""Fresnel terms: the dielectric's reflectance and refraction terms, the
conductor's reflectance for a complex index eta = eta_re + i * eta_im, and
the polarized amplitudes of both.

Complex numbers are (re, im) pairs of real tensors, not torch's complex
dtype, so that every formula and its rounding follow the JAX package's
step for step (its `librender/fresnel.py`)."""
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
    F = 0. Under total internal reflection the amplitudes divide by 1, not
    by their denominators, which vanish at grazing incidence: F there is
    1 all the same, and the gradient stays finite (the JAX package's is
    NaN through 0 / 0). A zero index (the row of another BSDF type, whose
    lanes the type's select drops) is taken as 1, so that no 1 / 0 makes
    a NaN whose gradient the select cannot drop."""
    outside = cos_theta_i >= 0.0
    eta = torch.where(eta == 0.0, 1.0, eta)
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    cos_theta_t_abs = m.safe_sqrt(cos_theta_t_sqr)
    tir = cos_theta_t_sqr <= 0.0

    a_s = (cos_theta_i_abs - eta_it * cos_theta_t_abs) / torch.where(
        tir, 1.0, cos_theta_i_abs + eta_it * cos_theta_t_abs)
    a_p = (eta_it * cos_theta_i_abs - cos_theta_t_abs) / torch.where(
        tir, 1.0, eta_it * cos_theta_i_abs + cos_theta_t_abs)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(tir, 1.0, F)
    F = torch.where(eta == 1.0, 0.0, F)

    cos_theta_t = torch.where(tir, 0.0,
                              m.mulsign_neg(cos_theta_t_abs, cos_theta_i))
    return F, cos_theta_t, eta_it, eta_ti


# --- complex helpers on (re, im) pairs ---------------------------------------

def c_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def c_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def c_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def c_div(a, b):
    d = torch.clamp_min(b[0] * b[0] + b[1] * b[1], 1e-30)
    return ((a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d)


def c_rcp(a):
    d = torch.clamp_min(a[0] * a[0] + a[1] * a[1], 1e-30)
    return (a[0] / d, -a[1] / d)


def c_sqrt(a):
    """Principal square root. Each real root is `safe_sqrt`'s, whose
    gradient is zero where its argument is: on the real axis (|a| - a_re =
    0, at normal incidence in the Fresnel terms) a plain root's gradient is
    infinite and, times the zero derivative of its argument, NaN (as in
    the JAX package)."""
    r = m.safe_sqrt(a[0] * a[0] + a[1] * a[1])
    re = m.safe_sqrt(0.5 * (r + a[0]))
    im_mag = m.safe_sqrt(0.5 * (r - a[0]))
    return (re, torch.where(a[1] >= 0, im_mag, -im_mag))


def c_abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def c_conj(a):
    return (a[0], -a[1])


def c_scale(a, s):
    return (a[0] * s, a[1] * s)


def sincos_arg_diff(a, b):
    """(sin, cos) of arg(a) - arg(b), from a * conj(b) without trig; (0, 1)
    where that product vanishes."""
    p = c_mul(a, c_conj(b))
    n = torch.sqrt(torch.clamp_min(c_abs2(p), 1e-30))
    valid = c_abs2(p) > 1e-30
    return (torch.where(valid, p[1] / n, 0.0),
            torch.where(valid, p[0] / n, 1.0))


# --- polarized Fresnel (complex amplitudes) ----------------------------------

def _zero_where(bad, a):
    return (torch.where(bad, 0.0, a[0]), torch.where(bad, 0.0, a[1]))


def fresnel_polarized_dielectric(cos_theta_i, eta):
    """Polarized Fresnel of a real relative index eta (Verdet's sign of
    a_p): (a_s, a_p, cos_theta_t, eta_it, eta_ti), a_s and a_p complex
    pairs whose imaginary part carries the phase under total internal
    reflection, where cos_theta_t is 0. A zero index, whose amplitudes
    are zero, takes 1 in the other terms (as `fresnel_dielectric`)."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / torch.where(eta == 0.0, 1.0, eta)
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    ctt = c_sqrt((cos_theta_t_sqr, torch.zeros_like(cos_theta_t_sqr)))
    # the sign of the TIR phase (Clarke, "Stellar Polarimetry", A.2)
    ctt = (m.mulsign(ctt[0], cos_theta_t_sqr),
           m.mulsign(ctt[1], cos_theta_t_sqr))

    eit = (eta_it, torch.zeros_like(eta_it))
    cia = (cos_theta_i_abs, torch.zeros_like(cos_theta_i_abs))
    a_s = c_div(c_sub(cia, c_mul(eit, ctt)), c_add(cia, c_mul(eit, ctt)))
    a_p = c_div(c_sub(c_scale(eit, cos_theta_i_abs), ctt),
                c_add(c_scale(eit, cos_theta_i_abs), ctt))

    bad = (eta == 1.0) | (eta == 0.0)
    a_s, a_p = _zero_where(bad, a_s), _zero_where(bad, a_p)
    cos_theta_t = torch.where(cos_theta_t_sqr >= 0.0,
                              m.mulsign_neg(ctt[0], cos_theta_i), 0.0)
    return a_s, a_p, cos_theta_t, eta_it, eta_ti


def fresnel_polarized_conductor(cos_theta_i, eta_re, eta_im):
    """Polarized Fresnel of a complex index: (a_s, a_p, cos_theta_t,
    eta_it, eta_ti), eta_it and eta_ti complex pairs. The index is taken
    with a non-positive imaginary part, the convention of the polarized
    equations."""
    outside = cos_theta_i >= 0.0
    eta = (eta_re, torch.where(eta_im > 0.0, -eta_im, eta_im))
    rcp_eta = c_rcp(eta)
    eta_it = (torch.where(outside, eta[0], rcp_eta[0]),
              torch.where(outside, eta[1], rcp_eta[1]))
    eta_ti = (torch.where(outside, rcp_eta[0], eta[0]),
              torch.where(outside, rcp_eta[1], eta[1]))

    st2 = 1.0 - cos_theta_i * cos_theta_i
    ctt_sqr = c_sub((torch.ones_like(st2), torch.zeros_like(st2)),
                    c_scale(c_mul(eta_ti, eta_ti), st2))
    cos_theta_i_abs = torch.abs(cos_theta_i)
    ctt = c_sqrt(ctt_sqr)
    ctt = (ctt[0], torch.where(ctt[1] > 0, -ctt[1], ctt[1]))

    cia = (cos_theta_i_abs, torch.zeros_like(cos_theta_i_abs))
    a_s = c_div(c_sub(cia, c_mul(eta_it, ctt)), c_add(cia, c_mul(eta_it, ctt)))
    a_p = c_div(c_sub(c_scale(eta_it, cos_theta_i_abs), ctt),
                c_add(c_scale(eta_it, cos_theta_i_abs), ctt))

    sqn = c_abs2(eta)
    bad = ((sqn == 1.0) & (eta[1] == 0.0)) | (sqn == 0.0)
    a_s, a_p = _zero_where(bad, a_s), _zero_where(bad, a_p)
    cos_theta_t = torch.where(ctt_sqr[0] >= 0.0,
                              m.mulsign_neg(ctt[0], cos_theta_i), 0.0)
    return a_s, a_p, cos_theta_t, eta_it, eta_ti
