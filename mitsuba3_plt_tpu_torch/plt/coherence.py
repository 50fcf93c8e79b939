"""PLT coherence state and generalized radiance.

A wave packet's diffusivity matrix `dmat` [N, 2, 2] holds the angular
variance of its wave distribution around the mean direction, and `opl` the
optical path length from the source in metres. The inverse coherence
matrix is (k / 2 pi) / (opl * 1e3) * dmat (Steinberg et al., "A
Generalized Ray formulation for wave-optics rendering", Eq. 41); the
grating eval needs its determinant, the beam (`plt/beam.py`) the rest."""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m


def _quad(v, M):
    """v^T M v over the trailing axes: v [..., 2], M [..., 2, 2]."""
    return torch.einsum("...i,...ij,...j->...", v, M, v)


@dataclasses.dataclass(frozen=True)
class Coherence:
    dmat: torch.Tensor  # [N, 2, 2] diffusivity matrix
    opl: torch.Tensor   # [N] metres

    @staticmethod
    def isotropic(diffusivity, opl):
        d, o = torch.broadcast_tensors(torch.as_tensor(diffusivity),
                                       torch.as_tensor(opl))
        eye = torch.eye(2, dtype=torch.float32, device=d.device)
        return Coherence(dmat=d.float()[..., None, None] * eye, opl=o.float())

    def rmm(self):
        """Distance from the source in millimetres."""
        return self.opl * 1e3

    def propagate(self, rd, mask=None):
        """The optical path length grown by rd (where mask)."""
        opl = self.opl + rd
        if mask is not None:
            opl = torch.where(mask, opl, self.opl)
        return dataclasses.replace(self, opl=opl)

    def inv_coherence_matrix(self, k=None):
        """Inverse coherence matrix [..., 2, 2], times k / 2 pi where k
        (1/um) is given; k may carry trailing axes beyond opl's (a
        wavelength axis [N, C])."""
        scale = 1.0 / torch.clamp_min(self.rmm(), 1e-30)
        dmat = self.dmat
        if k is not None:
            k = torch.as_tensor(k)
            extra = k.dim() - scale.dim()
            if extra > 0:
                scale = scale.reshape(scale.shape + (1,) * extra)
                dmat = dmat.reshape(dmat.shape[:-2] + (1,) * extra
                                    + dmat.shape[-2:])
            scale = scale * (k / m.TwoPi)
        return scale[..., None, None] * dmat

    def inv_coherence_det(self, k=None):
        ic = self.inv_coherence_matrix(k)
        return ic[..., 0, 0] * ic[..., 1, 1] - ic[..., 0, 1] * ic[..., 1, 0]

    def transform(self, U, mask=None):
        """dmat <- U^T dmat U (where mask)."""
        new = torch.einsum("...ji,...jk,...kl->...il", U, self.dmat, U)
        if mask is not None:
            new = torch.where(mask[..., None, None], new, self.dmat)
        return dataclasses.replace(self, dmat=new)


@dataclasses.dataclass(frozen=True)
class GeneralizedRadiance:
    """Generalized Stokes parameters of a wave packet: the intensity L and
    the polarization components L1..L3 ([N, C] each), with the packet's
    coherence."""

    L: torch.Tensor
    L1: torch.Tensor
    L2: torch.Tensor
    L3: torch.Tensor
    coherence: Coherence

    @staticmethod
    def from_value(L):
        z = torch.zeros_like(L)
        n = L.shape[0]
        return GeneralizedRadiance(
            L=L, L1=z, L2=z, L3=z, coherence=Coherence.isotropic(
                torch.full((n,), 1e-3, device=L.device),
                torch.zeros((n,), device=L.device)))

    @staticmethod
    def from_stokes(S, coherence: Coherence):
        """Stokes [N, 4, C] and a coherence."""
        return GeneralizedRadiance(L=S[:, 0], L1=S[:, 1], L2=S[:, 2],
                                   L3=S[:, 3], coherence=coherence)

    def stokes(self):
        """[N, 4, C]."""
        return torch.stack([self.L, self.L1, self.L2, self.L3], dim=1)


def mutual_coherence(coh: Coherence, diff_xy, k=None):
    """Spatial mutual coherence of two points diff_xy [N, 2] apart in the
    transverse plane."""
    return torch.exp(-0.5 * _quad(diff_xy, coh.inv_coherence_matrix(k)))


def mutual_coherence_angular(coh: Coherence, d1, d2):
    """Angular mutual coherence of two transverse directions."""
    dxy = torch.abs(d1[..., :2] - d2[..., :2])
    v = 1.0 / torch.clamp_min(torch.sqrt(torch.tensor(4.0 * m.Pi)) * dxy,
                              m.Epsilon)
    inv_c = coh.inv_coherence_matrix() * coh.rmm()[..., None, None]
    return torch.exp(-0.5 / torch.clamp_min(_quad(v, inv_c), 1e-30))
