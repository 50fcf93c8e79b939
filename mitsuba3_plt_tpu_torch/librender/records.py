"""Per-lane records: rays, hit records, BSDF and emitter samples (struct of
tensors, one entry per wavefront lane)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import frame as fr


@dataclasses.dataclass(frozen=True)
class Ray:
    o: torch.Tensor     # [N, 3]
    d: torch.Tensor     # [N, 3] unit
    maxt: torch.Tensor  # [N]

    @staticmethod
    def create(o, d, maxt=None):
        if maxt is None:
            maxt = torch.full(o.shape[:-1], float("inf"), dtype=o.dtype,
                              device=o.device)
        return Ray(o=o, d=d, maxt=maxt)


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    """Hit record; wi lives in the shading frame (sh_s, sh_t, sh_n)."""

    valid: torch.Tensor        # [N] bool
    t: torch.Tensor            # [N]
    p: torch.Tensor            # [N, 3]
    n: torch.Tensor            # [N, 3] geometric normal
    sh_s: torch.Tensor         # [N, 3]
    sh_t: torch.Tensor         # [N, 3]
    sh_n: torch.Tensor         # [N, 3]
    uv: torch.Tensor           # [N, 2]
    wi: torch.Tensor           # [N, 3] local
    prim_idx: torch.Tensor     # [N] int32
    mat_idx: torch.Tensor      # [N] int64
    emitter_idx: torch.Tensor  # [N] int64, -1 if none

    def to_local(self, v):
        return torch.stack(
            [fr.dot(v, self.sh_s), fr.dot(v, self.sh_t), fr.dot(v, self.sh_n)],
            dim=-1,
        )

    def to_world(self, v):
        return (self.sh_s * v[..., 0:1] + self.sh_t * v[..., 1:2]
                + self.sh_n * v[..., 2:3])


@dataclasses.dataclass(frozen=True)
class BSDFSample:
    wo: torch.Tensor            # [N, 3] local
    pdf: torch.Tensor           # [N]
    sampled_type: torch.Tensor  # [N] int64 BSDFFlags

    @staticmethod
    def zeros(n, device):
        return BSDFSample(
            wo=torch.zeros((n, 3), device=device),
            pdf=torch.zeros((n,), device=device),
            sampled_type=torch.zeros((n,), dtype=torch.int64, device=device),
        )

    def where(self, mask, other: "BSDFSample") -> "BSDFSample":
        """Per lane: self where mask, else other."""
        return BSDFSample(
            wo=torch.where(mask[..., None], self.wo, other.wo),
            pdf=torch.where(mask, self.pdf, other.pdf),
            sampled_type=torch.where(mask, self.sampled_type,
                                     other.sampled_type),
        )


@dataclasses.dataclass(frozen=True)
class DirectionSample:
    """Emitter direction sample (NEE)."""

    d: torch.Tensor            # [N, 3] toward the emitter (world)
    dist: torch.Tensor         # [N]
    pdf: torch.Tensor          # [N] solid-angle density
    delta: torch.Tensor        # [N] bool
    emitter_idx: torch.Tensor  # [N] int64

    def where(self, mask, other: "DirectionSample") -> "DirectionSample":
        mm = mask[..., None]
        return DirectionSample(
            d=torch.where(mm, self.d, other.d),
            dist=torch.where(mask, self.dist, other.dist),
            pdf=torch.where(mask, self.pdf, other.pdf),
            delta=torch.where(mask, self.delta, other.delta),
            emitter_idx=torch.where(mask, self.emitter_idx, other.emitter_idx),
        )
