"""Unpolarized conductor Fresnel reflectance for a complex index
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
