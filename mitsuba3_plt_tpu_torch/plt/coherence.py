"""PLT coherence state for the isotropic case the RGB path uses.

A wave packet's diffusivity matrix is d * I (isotropic) and `opl` is the
optical path length from the source in metres. The inverse coherence
matrix is (k / 2 pi) / (opl * 1e3) * dmat (Steinberg et al., "A Generalized
Ray formulation for wave-optics rendering", Eq. 41); the grating eval
needs its determinant."""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m


@dataclasses.dataclass(frozen=True)
class Coherence:
    diffusivity: torch.Tensor  # [N]
    opl: torch.Tensor          # [N] metres

    @staticmethod
    def isotropic(diffusivity, opl):
        return Coherence(diffusivity=diffusivity, opl=opl)

    def inv_coherence_det(self, k):
        """det of the inverse coherence matrix; k [N] or [N, C] in 1/um."""
        scale = 1.0 / torch.clamp_min(self.opl * 1e3, 1e-30)
        d = self.diffusivity
        if k.dim() > scale.dim():
            scale, d = scale[..., None], d[..., None]
        ic = scale * (k / m.TwoPi) * d
        return ic * ic
