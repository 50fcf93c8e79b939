"""Perspective sensor: film-plane samples in [0,1]^2 -> world-space rays."""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr


@dataclasses.dataclass(frozen=True)
class Sensor:
    to_world: torch.Tensor    # [4, 4]
    tan_half_x: torch.Tensor  # scalar: tan(fov_x / 2)
    aspect: torch.Tensor      # scalar: width / height
    ppo: torch.Tensor         # [2] principal point offset
    resolution: tuple         # (width, height)

    def sample_ray(self, film_uv):
        """film_uv [N, 2] -> (o [N, 3], d [N, 3]); u=0 is camera +x
        ('left'), v=0 is +y (top), the camera looks along +z."""
        u = film_uv[..., 0]
        v = film_uv[..., 1]
        R = self.to_world[:3, :3]
        t = self.to_world[:3, 3]
        tx = self.tan_half_x
        ty = self.tan_half_x / self.aspect
        x = (1.0 - 2.0 * (u + self.ppo[0])) * tx
        y = (1.0 - 2.0 * (v + self.ppo[1])) * ty
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        o = t.expand(d_cam.shape).contiguous()
        d = fr.normalize(d_cam @ R.T)
        return o, d
