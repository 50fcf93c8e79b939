"""PLTBeam: a sourced wave packet with its Stokes state, frame and
coherence (the JAX package's `plt/beam.py`, after the reference's
`include/mitsuba/plt/beam.h`).

The PLT integrator's `source_beam` and `measured_beam` build and move one;
`measure` returns the replayed radiance unchanged, because every sensor
the package has responds to intensity (see `integrators/plt.py`)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr
from ..core import math as m
from ..core.frame import coordinate_system
from ..librender import mueller as mu
from .coherence import Coherence, _quad


def _unpolarized(Le):
    """Stokes [N, 4, C] of the unpolarized radiance Le [N, C]."""
    z = torch.zeros_like(Le)
    return torch.stack([Le, z, z, z], dim=1)


@dataclasses.dataclass(frozen=True)
class PLTBeam:
    sp: torch.Tensor       # [N, 4, C] Stokes (or [N, 1, C] intensity)
    origin: torch.Tensor   # [N, 3]
    dir: torch.Tensor      # [N, 3] propagation direction
    tangent: torch.Tensor  # [N, 3] horizontal linear-polarization axis
    distant: torch.Tensor  # [N] bool
    coherence: Coherence
    active: torch.Tensor   # [N] bool

    def transverse_rotation(self):
        """[N, 2, 3] rows (tangent, tangent x dir): world -> transverse
        plane."""
        return torch.stack([self.tangent, fr.cross(self.tangent, self.dir)],
                           dim=-2)

    def mutual_coherence(self, k, diff):
        """Spatial mutual coherence for a world offset diff [N, 3]."""
        dxy = torch.einsum("nij,nj->ni", self.transverse_rotation(), diff)
        return torch.exp(-0.5 * _quad(
            dxy, self.coherence.inv_coherence_matrix(k)))

    def mutual_coherence_angular(self, d1, d2):
        """Angular mutual coherence of two world directions."""
        R = self.transverse_rotation()
        d1xy = torch.einsum("nij,nj->ni", R, d1)
        d2xy = torch.einsum("nij,nj->ni", R, d2)
        v = 1.0 / torch.clamp_min(
            torch.sqrt(torch.tensor(4.0 * m.Pi)) * torch.abs(d1xy - d2xy),
            m.Epsilon)
        inv_c = (self.coherence.inv_coherence_matrix()
                 * self.coherence.rmm()[..., None, None])
        return torch.exp(-0.5 / torch.clamp_min(_quad(v, inv_c), 1e-30))

    def rotate_frame(self, new_tangent):
        """The Stokes basis turned about dir onto new_tangent."""
        sp = self.sp
        if sp.shape[1] == 4:
            R = mu.rotate_stokes_basis(self.dir, self.tangent, new_tangent)
            sp = torch.einsum("ijn,njc->nic", R, sp)
        return dataclasses.replace(self, sp=sp, tangent=new_tangent)

    def propagate(self, p):
        """Moved to the point p: the path length grows unless distant."""
        coh = self.coherence.propagate(fr.norm(p - self.origin),
                                       ~self.distant)
        return dataclasses.replace(self, origin=p, coherence=coh)

    @staticmethod
    def source_distant(direction, solid_angle, Le, max_beam_omega,
                       force_fully_coherent=False):
        """A distant source's beam (environment, directional): diffusivity
        min(solid_angle, max_beam_omega), path length 1 mm."""
        n, dev = direction.shape[0], direction.device
        sa = torch.clamp_max(solid_angle, max_beam_omega)
        diff = torch.full_like(sa, 1e-9) if force_fully_coherent else sa
        _, t = coordinate_system(direction)
        return PLTBeam(
            sp=_unpolarized(Le), origin=torch.zeros((n, 3), device=dev),
            dir=direction, tangent=t,
            distant=torch.ones((n,), dtype=torch.bool, device=dev),
            coherence=Coherence.isotropic(
                diff, torch.full((n,), 1e-3, device=dev)),
            active=torch.ones((n,), dtype=torch.bool, device=dev))

    @staticmethod
    def source_area(pos, direction, area, dist, Le, max_beam_omega,
                    force_fully_coherent=False):
        """An area emitter's beam: diffusivity min(area, max_beam_omega
        (dist in mm)^2), path length 0."""
        n, dev = direction.shape[0], direction.device
        A = torch.minimum(area, max_beam_omega * m.sqr(dist * 1e3))
        diff = torch.full_like(A, 1e-7) if force_fully_coherent else A
        _, t = coordinate_system(direction)
        return PLTBeam(
            sp=_unpolarized(Le), origin=pos, dir=direction, tangent=t,
            distant=torch.zeros((n,), dtype=torch.bool, device=dev),
            coherence=Coherence.isotropic(diff, torch.zeros((n,),
                                                            device=dev)),
            active=torch.ones((n,), dtype=torch.bool, device=dev))

    def where(self, mask, other: "PLTBeam") -> "PLTBeam":
        """Per lane: self where mask [N], else other."""
        def sel(a, b):
            return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                               a, b)

        return PLTBeam(
            sp=sel(self.sp, other.sp), origin=sel(self.origin, other.origin),
            dir=sel(self.dir, other.dir),
            tangent=sel(self.tangent, other.tangent),
            distant=sel(self.distant, other.distant),
            coherence=Coherence(
                dmat=sel(self.coherence.dmat, other.coherence.dmat),
                opl=sel(self.coherence.opl, other.coherence.opl)),
            active=sel(self.active, other.active))
