"""Box-filter film for pixel-ordered wavefronts.

Lane i belongs to pixel i // spp (the camera layout of
`integrators.common.sample_rays`), so the splat is a reshape and a sum:
deterministic, no scatter. The buffer is [H*W, C+1]; the last channel is the
accumulated sample weight."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ImageBlock:
    data: torch.Tensor  # [H*W, C+1]
    width: int
    height: int
    n_channels: int

    @staticmethod
    def create(width, height, n_channels, device):
        return ImageBlock(
            data=torch.zeros((width * height, n_channels + 1),
                             dtype=torch.float32, device=device),
            width=width, height=height, n_channels=n_channels,
        )

    def put_ordered(self, values, active, spp: int):
        """Accumulate values [N, C] of pixel-ordered lanes into the buffer
        (in place); non-finite or inactive lanes count neither value nor
        weight."""
        active = active & torch.all(torch.isfinite(values), dim=-1)
        vals = torch.where(active[..., None], values, 0.0)
        payload = torch.cat([vals, active.to(torch.float32)[..., None]], -1)
        self.data += payload.reshape(self.width * self.height, spp,
                                     -1).sum(dim=1)
        return self

    def develop(self):
        """-> [H, W, C] image: value / weight."""
        img = self.data[..., :-1] / torch.clamp_min(self.data[..., -1:], 1e-8)
        return img.reshape(self.height, self.width, self.n_channels)
