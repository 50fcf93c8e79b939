"""Warps from [0,1)^2 used by the PLT path: the cosine hemisphere (diffuse
sampling) and the uniform sphere (constant-emitter sampling)."""
from __future__ import annotations

import torch

from . import math as m


def square_to_uniform_disk_concentric(u):
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = torch.abs(x) < torch.abs(y)
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    r_safe = torch.where(r == 0.0, 1.0, r)
    phi = 0.25 * m.Pi * rp / r_safe
    phi = torch.where(quadrant_1_or_3, 0.5 * m.Pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(u):
    p = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.clamp_min(v[..., 2], 0.0) * m.InvPi


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * m.Pi * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
