"""Numeric constants and helpers used by the PLT path (float32 throughout)."""
from __future__ import annotations

import numpy as np
import torch

Pi = 3.14159265358979323846
InvPi = 1.0 / Pi
TwoPi = 2.0 * Pi
InvFourPi = 1.0 / (4.0 * Pi)

# float32 machine epsilon / 2 is what drjit calls Epsilon
Epsilon = float(np.finfo(np.float32).eps) / 2.0
RayEpsilon = Epsilon * 1500.0          # ~8.9e-5
ShadowEpsilon = RayEpsilon * 10.0      # ~8.9e-4


def sqr(x):
    return x * x


def safe_sqrt(x):
    """sqrt of x where x > 0, else 0 (NaN included, as in the JAX twin)."""
    return torch.sqrt(torch.where(x > 0, x, 0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp_min(x, 1e-30))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def mulsign(x, s):
    """x * sign(s) with sign(0) == +1."""
    return torch.where(s >= 0, x, -x)


def mulsign_neg(x, s):
    return torch.where(s >= 0, -x, x)


def sign(x):
    """sign with sign(0) == +1 (drjit convention)."""
    return torch.where(x >= 0, 1.0, -1.0)


def unit_angle_dot(dot_uv):
    """Angle between two unit vectors from their dot product, by the
    half-angle form 2*asin(|u-v|/2) (|u-v|^2 = 2 - 2 u.v)."""
    d = safe_sqrt(2.0 - 2.0 * torch.abs(dot_uv))
    theta = 2.0 * safe_asin(0.5 * d)
    return torch.where(dot_uv < 0, Pi - theta, theta)


def sinc(x):
    """Unnormalized sinc: sin(x)/x with sinc(0) = 1."""
    small = torch.abs(x) < 1e-8
    x_safe = torch.where(small, 1.0, x)
    return torch.where(small, 1.0, torch.sin(x_safe) / x_safe)


def bessel_j_asymp(x, nu):
    """Two-term Hankel asymptotic expansion of J_nu; accurate for
    |x| >> nu^2."""
    x_abs = torch.abs(x)
    x_safe = torch.clamp_min(x_abs, 1e-12)
    mu = 4.0 * nu * nu
    i8x = 1.0 / (8.0 * x_safe)
    p = 1.0 - (mu - 1.0) * (mu - 9.0) * 0.5 * i8x * i8x
    q = (mu - 1.0) * i8x
    omega = x_abs - (0.5 * nu + 0.25) * Pi
    val = torch.sqrt(2.0 / (Pi * x_safe)) * (
        torch.cos(omega) * p - torch.sin(omega) * q
    )
    tiny = x_abs <= 10.0 * Epsilon
    return torch.where(tiny, torch.where(nu == 0, 1.0, 0.0), val)


def bessel_jn_fast(x, n_max: int, M: int = 64):
    """J_0(|x|)..J_{n_max}(|x|) -> [..., n_max+1] by Miller's downward
    recurrence from order M, normalized by J0 + 2*sum J_2k = 1, with a
    1e18 rescale guard; beyond |x| > M/2 the Hankel asymptotics take over.
    """
    x_abs = torch.abs(x.to(torch.float32))
    switch = 0.5 * M
    unsafe = (x_abs < 1e-6) | (x_abs > switch)
    x_safe = torch.where(unsafe, 1.0, x_abs)
    inv_x = 1.0 / x_safe

    jp1 = torch.zeros_like(x_safe)
    jk = torch.full_like(x_safe, 1e-30)
    norm = torch.zeros_like(x_safe)
    outs = [None] * (n_max + 1)
    for i in range(M):
        k = float(M - i)
        jm1 = (2.0 * k) * inv_x * jk - jp1
        jp1, jk = jk, jm1
        scale = torch.where(torch.abs(jk) > 1e18, 1e-18, 1.0)
        kk = M - i - 1  # jk now holds J_kk (unnormalized)
        if kk % 2 == 0:
            norm = norm + (jk if kk == 0 else 2.0 * jk)
        jp1 = jp1 * scale
        jk = jk * scale
        norm = norm * scale
        if kk <= n_max:
            outs[kk] = jk
            for j in range(kk + 1, n_max + 1):
                outs[j] = outs[j] * scale

    res = torch.stack(outs, dim=-1)
    res = res / torch.clamp_min(torch.abs(norm), 1e-30)[..., None]
    res = res * torch.sign(norm)[..., None]
    orders = torch.arange(n_max + 1, dtype=torch.float32, device=x.device)
    asym = bessel_j_asymp(x_abs[..., None], orders)
    res = torch.where((x_abs > switch)[..., None], asym, res)
    exact0 = torch.zeros(n_max + 1, dtype=torch.float32, device=x.device)
    exact0[0] = 1.0
    return torch.where((x_abs < 1e-6)[..., None], exact0, res)
