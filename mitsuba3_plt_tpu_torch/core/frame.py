"""Orthonormal frames and local-frame helpers on [..., 3] vectors."""
from __future__ import annotations

import torch

from . import math as m


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def squared_norm(a):
    return torch.sum(a * a, dim=-1)


def norm(a):
    return torch.sqrt(squared_norm(a))


def normalize(a):
    """Safe normalize: 0 for (near-)zero vectors."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    return a * torch.rsqrt(torch.clamp_min(n2, 1e-24))


def coordinate_system(n):
    """Complete unit vector n to an orthonormal basis (s, t), branchless
    (Duff, Burgess, Christensen, Hery, Kensler, Liani, Villemin, JCGT 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = m.sign(nz)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack(
        [m.mulsign(nx * nx * a, nz) + 1.0, m.mulsign(b, nz),
         m.mulsign_neg(nx, nz)],
        dim=-1,
    )
    t = torch.stack([b, ny * ny * a + sign, -ny], dim=-1)
    return s, t


def cos_theta(v):
    return v[..., 2]


def reflect_n(wi, n):
    """Reflect wi (pointing away from the surface) around normal n."""
    return 2.0 * dot(wi, n)[..., None] * n - wi
