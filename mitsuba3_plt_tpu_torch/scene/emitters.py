"""Emitter table and NEE direction sampling for distant emitters
(directional and constant): an emitter is picked uniformly, then a
direction on it; densities are in solid angle."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import math as m
from ..core import warp
from ..librender.records import DirectionSample

# type tags: the JAX package's values
EMITTER_CONSTANT = 2
EMITTER_DIRECTIONAL = 3
SUPPORTED = (EMITTER_CONSTANT, EMITTER_DIRECTIONAL)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    etype: torch.Tensor         # [E] int64
    radiance: torch.Tensor      # [E, 3]
    direction: torch.Tensor     # [E, 3] propagation direction (directional)
    scene_radius: torch.Tensor  # scalar: bounding-sphere radius
    present_types: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return self.etype.shape[0]


def sample_emitter_direction(em: EmitterTable, ref_p, sample1, sample2,
                             active):
    """Direction toward one uniformly chosen emitter from ref_p [N, 3]."""
    n, dev = ref_p.shape[0], ref_p.device
    e_idx = torch.clamp((sample1 * em.count).to(torch.int64), 0, em.count - 1)
    etype = em.etype[e_idx]
    ds = DirectionSample(
        d=torch.zeros((n, 3), device=dev), dist=torch.zeros((n,), device=dev),
        pdf=torch.zeros((n,), device=dev),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        emitter_idx=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    dist = 2.0 * em.scene_radius + 1.0
    for t in em.present_types:
        if t == EMITTER_CONSTANT:
            d = warp.square_to_uniform_sphere(sample2)
            pdf, delta = m.InvFourPi, False
        elif t == EMITTER_DIRECTIONAL:
            # the direction property points away from the emitter
            d = -em.direction[e_idx]
            pdf, delta = 1.0, True
        else:
            raise NotImplementedError(f"emitter type {t} is not ported")
        cand = DirectionSample(
            d=d,
            dist=dist.expand(n),
            pdf=torch.full((n,), pdf, device=dev),
            delta=torch.full((n,), delta, dtype=torch.bool, device=dev),
            emitter_idx=e_idx,
        )
        ds = cand.where(etype == t, ds)
    return dataclasses.replace(
        ds, pdf=torch.where(active, ds.pdf / em.count, 0.0))


def pdf_emitter_direction(em: EmitterTable, ds: DirectionSample):
    """Solid-angle density of sampling ds (0 for delta emitters)."""
    etype = em.etype[torch.clamp_min(ds.emitter_idx, 0)]
    pdf = torch.zeros(ds.d.shape[0], device=ds.d.device)
    if EMITTER_CONSTANT in em.present_types:
        pdf = torch.where(etype == EMITTER_CONSTANT, m.InvFourPi, pdf)
    return pdf / em.count


def emitter_value(em: EmitterTable, e_idx, active):
    """RGB radiance [N, 3] arriving from emitter e_idx (0 where inactive or
    e_idx < 0)."""
    val = em.radiance[torch.clamp_min(e_idx, 0)]
    return torch.where((active & (e_idx >= 0))[..., None], val, 0.0)
