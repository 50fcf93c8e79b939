"""Per-lane diffraction-grating state (sinusoidal / rectangular / linear,
optionally radial). Units: wavelengths in micrometres, inv_period in 1/um,
height q in um, wavenumber k = 2 pi / wl_um.

The per-order intensities, lobe sampling and lobe sum run in the kernels of
`ops/grating.py`; this module holds the state they read and the far-field
alpha that the wave pdf uses."""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m

SINUSOIDAL = 0x00
RECTANGULAR = 0x01
LINEAR = 0x02
RADIAL = 0x10
TYPE_MASK = 0xF


@dataclasses.dataclass(frozen=True)
class Grating:
    grating_dir: torch.Tensor  # [N, 2] unit direction in the tangent plane
    inv_period: torch.Tensor   # [N, 2] 1/um
    q: torch.Tensor            # [N] height (um)
    lobes: torch.Tensor        # [N] int32 total lobe count (odd)
    gtype: torch.Tensor        # [N] int32 type bits
    multiplier: torch.Tensor   # [N]

    @staticmethod
    def create(inv_period, q, lobes, gtype, multiplier, uv,
               grating_angle: float = 0.0):
        """Radial gratings take their direction from the uv coordinate."""
        import math

        ca, sa = math.cos(grating_angle), math.sin(grating_angle)
        radial = uv - 0.5
        radial = radial / torch.clamp_min(
            torch.linalg.vector_norm(radial, dim=-1, keepdim=True), 1e-12)
        rx, ry = radial[..., 0], -radial[..., 1]
        rad_dir = torch.stack([ca * rx + sa * ry, -sa * rx + ca * ry], dim=-1)
        lin_dir = torch.tensor([ca, sa], dtype=torch.float32,
                               device=uv.device).expand_as(rad_dir)
        is_radial = (gtype & RADIAL) != 0
        return Grating(
            grating_dir=torch.where(is_radial[..., None], rad_dir, lin_dir),
            inv_period=inv_period, q=q, lobes=lobes.to(torch.int32),
            gtype=gtype.to(torch.int32), multiplier=multiplier,
        )

    def alpha(self, wi, k):
        """Far-field roughness exp(-(cos_i q k)^2); wi [N, 3], k [N]."""
        return torch.exp(-m.sqr(wi[..., 2] * self.q * k))
