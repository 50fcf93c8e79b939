"""Emitter table and NEE direction sampling for area lights, point lights
and distant emitters (directional and constant): an emitter is picked
uniformly, then a direction on it; densities are in solid angle, and the
delta emitters (point, directional) carry pdf 1. An area light samples one
of its triangles by the area CDF of its `tri_cdf` row, then a point on it
uniformly (`Geometry.tri_isect` rows). Escaped rays see the constant
emitter (`env_value`, `escape_pdf`)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import frame as fr
from ..core import math as m
from ..core import warp
from ..core.math import take_rows
from ..librender.records import DirectionSample

# type tags: the JAX package's values
EMITTER_AREA = 0
EMITTER_POINT = 1
EMITTER_CONSTANT = 2
EMITTER_DIRECTIONAL = 3
SUPPORTED = (EMITTER_AREA, EMITTER_POINT, EMITTER_CONSTANT,
             EMITTER_DIRECTIONAL)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    etype: torch.Tensor         # [E] int64
    radiance: torch.Tensor      # [E, 3] radiance, or intensity (point)
    position: torch.Tensor      # [E, 3] (point)
    direction: torch.Tensor     # [E, 3] propagation direction (directional)
    # area lights: their triangles (-1 pads a row), the normalised area CDF
    # over them (1 in the padding) and their total area (0 for the others)
    tri_idx: torch.Tensor       # [E, T] int64
    tri_cdf: torch.Tensor       # [E, T]
    area: torch.Tensor          # [E]
    scene_radius: torch.Tensor  # scalar: bounding-sphere radius
    present_types: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return self.etype.shape[0]


def _sample_area(em: EmitterTable, geo, ref_p, e_idx, sample2):
    """A point on emitter e_idx's triangles, uniform in area: the triangle
    is the slot of the area CDF that sample2[0] falls in, and sample2[0],
    rescaled within that slot, and sample2[1] pick the point on it."""
    n = ref_p.shape[0]
    cdf = take_rows(em.tri_cdf, e_idx)  # [N, T]
    u = sample2[..., 0]
    slot = torch.clamp((cdf < u[..., None]).sum(-1), 0, cdf.shape[1] - 1)
    tri = torch.clamp_min(em.tri_idx[e_idx, slot], 0)
    lo = torch.where(slot > 0, cdf.gather(1, torch.clamp_min(
        slot - 1, 0)[:, None])[:, 0], 0.0)
    hi = cdf.gather(1, slot[:, None])[:, 0]
    u_re = torch.clamp((u - lo) / torch.clamp_min(hi - lo, 1e-12), 0.0,
                       1.0 - 1e-6)
    bary = warp.square_to_uniform_triangle(
        torch.stack([u_re, sample2[..., 1]], dim=-1))

    rows = take_rows(geo.tri_isect, tri)
    p0 = rows[..., 0:3]
    p1 = p0 + rows[..., 3:6]
    p2 = p0 + rows[..., 6:9]
    pos = (p0 * (1.0 - bary[..., 0:1] - bary[..., 1:2])
           + p1 * bary[..., 0:1] + p2 * bary[..., 1:2])
    ng = fr.normalize(torch.cross(p1 - p0, p2 - p0, dim=-1))

    to_l = pos - ref_p
    dist2 = fr.squared_norm(to_l)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    d = to_l / dist[..., None]
    cos_l = -fr.dot(d, ng)
    area = torch.clamp_min(take_rows(em.area, e_idx), 1e-12)
    pdf = torch.where(cos_l > 1e-6,
                      dist2 / (torch.clamp_min(cos_l, 1e-9) * area), 0.0)
    return DirectionSample(
        p=pos, n=ng, uv=bary, d=d, dist=dist, pdf=pdf,
        delta=torch.zeros((n,), dtype=torch.bool, device=ref_p.device),
        emitter_idx=e_idx)


def sample_emitter_direction(em: EmitterTable, geo, ref_p, sample1,
                             sample2, active):
    """Direction toward one uniformly chosen emitter from ref_p [N, 3]; geo
    is the scene's Geometry (area lights read its `tri_isect` rows)."""
    n, dev = ref_p.shape[0], ref_p.device
    e_idx = torch.clamp((sample1 * em.count).to(torch.int64), 0, em.count - 1)
    etype = em.etype[e_idx]
    z3 = torch.zeros((n, 3), device=dev)
    z1 = torch.zeros((n,), device=dev)
    # p, n and uv are an area light's alone: the other types carry these
    # very tensors, which `where` passes through without a select
    ds = DirectionSample(
        p=z3, n=z3, uv=z3[:, :2], d=z3, dist=z1,
        pdf=z1, delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        emitter_idx=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    dist = 2.0 * em.scene_radius + 1.0
    for t in em.present_types:
        if t == EMITTER_AREA:
            ds = _sample_area(em, geo, ref_p, e_idx, sample2).where(
                etype == t, ds)
            continue
        t_dist = dist.expand(n)
        if t == EMITTER_POINT:
            to_l = take_rows(em.position, e_idx) - ref_p
            t_dist = torch.sqrt(torch.clamp_min(fr.squared_norm(to_l), 1e-20))
            d = to_l / t_dist[..., None]
            pdf, delta = 1.0, True
        elif t == EMITTER_CONSTANT:
            d = warp.square_to_uniform_sphere(sample2)
            pdf, delta = m.InvFourPi, False
        elif t == EMITTER_DIRECTIONAL:
            # the direction property points away from the emitter
            d = -take_rows(em.direction, e_idx)
            pdf, delta = 1.0, True
        else:
            raise NotImplementedError(f"emitter type {t} is not ported")
        cand = DirectionSample(
            p=ds.p, n=ds.n, uv=ds.uv,
            d=d,
            dist=t_dist,
            pdf=torch.full((n,), pdf, device=dev),
            delta=torch.full((n,), delta, dtype=torch.bool, device=dev),
            emitter_idx=e_idx,
        )
        ds = cand.where(etype == t, ds)
    return dataclasses.replace(
        ds, pdf=torch.where(active, ds.pdf / em.count, 0.0))


def pdf_emitter_direction(em: EmitterTable, ds: DirectionSample):
    """Solid-angle density of sampling ds (0 for delta emitters): an area
    light's reads ds.d, ds.dist and the light's normal ds.n."""
    etype = em.etype[torch.clamp_min(ds.emitter_idx, 0)]
    pdf = torch.zeros(ds.d.shape[0], device=ds.d.device)
    if EMITTER_AREA in em.present_types:
        cos_l = -fr.dot(ds.d, ds.n)
        area = torch.clamp_min(
            take_rows(em.area, torch.clamp_min(ds.emitter_idx, 0)), 1e-12)
        p = torch.where(cos_l > 0, ds.dist * ds.dist / (
            torch.clamp_min(cos_l, 1e-9) * area), 0.0)
        pdf = torch.where(etype == EMITTER_AREA, p, pdf)
    if EMITTER_CONSTANT in em.present_types:
        pdf = torch.where(etype == EMITTER_CONSTANT, m.InvFourPi, pdf)
    return pdf / em.count


def emitter_value(em: EmitterTable, e_idx, d, dist, active):
    """RGB radiance [N, 3] arriving along -d from emitter e_idx at distance
    dist (0 where inactive or e_idx < 0): an area light's radiance as it
    is, a point light's intensity falling off as 1 / dist^2."""
    e_c = torch.clamp_min(e_idx, 0)
    val = take_rows(em.radiance, e_c)
    if EMITTER_POINT in em.present_types:
        point = em.etype[e_c] == EMITTER_POINT
        val = torch.where(
            point[..., None],
            val / torch.clamp_min(dist * dist, 1e-12)[..., None], val)
    return torch.where((active & (e_idx >= 0))[..., None], val, 0.0)


def env_value(em: EmitterTable, d):
    """RGB radiance [N, 3] that an escaped ray of direction d [N, 3] sees:
    the constant emitters' radiance summed (one is assumed)."""
    rad = torch.where((em.etype == EMITTER_CONSTANT)[:, None], em.radiance,
                      0.0).sum(0)
    return rad.expand(d.shape[0], 3)


def escape_pdf(em: EmitterTable, d):
    """NEE density [N] of the environment producing direction d: the MIS
    counterpart of an escaped ray (the constant emitter's uniform sphere
    over the emitter count)."""
    p = torch.zeros(d.shape[:-1], device=d.device)
    if EMITTER_CONSTANT in em.present_types:
        p = p + m.InvFourPi
    return p / max(em.count, 1)


def env_emitter_index(em: EmitterTable) -> int:
    """Index of the first constant emitter, -1 if there is none (host)."""
    idx = torch.nonzero(em.etype.cpu() == EMITTER_CONSTANT).flatten()
    return int(idx[0]) if len(idx) else -1
