"""Emitter table and NEE direction sampling for area lights, analytic
sphere lights, point lights and distant emitters (directional and
constant): an emitter is picked uniformly, then a direction on it;
densities are in solid angle, and the delta emitters (point, directional)
carry pdf 1. An area light samples one of its triangles by the area CDF of
its `tri_cdf` row, then a point on it uniformly (`Geometry.tri_isect`
rows). A sphere light samples the cone of directions it subtends from the
reference point, or, from inside, a point uniform on its area. Escaped
rays see the constant emitter (`env_value`, `escape_pdf`)."""
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
EMITTER_SPHERE = 7  # the radius rides in the cutoff_cos slot
SUPPORTED = (EMITTER_AREA, EMITTER_POINT, EMITTER_CONSTANT,
             EMITTER_DIRECTIONAL, EMITTER_SPHERE)


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    etype: torch.Tensor         # [E] int64
    radiance: torch.Tensor      # [E, 3] radiance, or intensity (point)
    position: torch.Tensor      # [E, 3] (point)
    direction: torch.Tensor     # [E, 3] propagation direction (directional)
    # [E]: a spot light's cutoff cosine in the JAX package; a sphere
    # light's radius
    cutoff_cos: torch.Tensor
    # area lights: their triangles (-1 pads a row), the normalised area CDF
    # over them (1 in the padding) and their total area (a sphere light's
    # 4 pi r^2, 0 for the others)
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


def _sphere_cone(em: EmitterTable, ref_p, e_idx):
    """(centre, radius, distance to the centre, the cone's cos_max) of
    sphere light e_idx seen from ref_p."""
    c = take_rows(em.position, e_idx)
    r = take_rows(em.cutoff_cos, e_idx)
    dc = fr.norm(c - ref_p)
    sin2 = torch.clamp((r / torch.clamp_min(dc, 1e-9)) ** 2, 0.0, 1.0)
    return c, r, dc, torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))


def _sample_sphere(em: EmitterTable, ref_p, e_idx, sample2):
    """A direction in the cone a sphere light subtends from ref_p, uniform
    in solid angle, and the near hit along it; from inside the sphere (at
    most r * 1.0001 from its centre), a point uniform on its area with the
    density converted to solid angle."""
    n = ref_p.shape[0]
    c, r, dc, cos_max = _sphere_cone(em, ref_p, e_idx)
    dhat = (c - ref_p) / torch.clamp_min(dc, 1e-9)[..., None]
    outside = dc > r * 1.0001
    cos_t = 1.0 - sample2[..., 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * m.Pi * sample2[..., 1]
    s_ax, t_ax = fr.coordinate_system(dhat)
    d = (s_ax * (sin_t * torch.cos(phi))[..., None]
         + t_ax * (sin_t * torch.sin(phi))[..., None]
         + dhat * cos_t[..., None])
    under = r * r - dc * dc * (1.0 - cos_t * cos_t)
    dist = dc * cos_t - torch.sqrt(torch.clamp_min(under, 0.0))
    p_hit = ref_p + d * dist[..., None]
    n_hit = fr.normalize(p_hit - c)
    pdf_cone = 1.0 / torch.clamp_min(2.0 * m.Pi * (1.0 - cos_max), 1e-9)

    p_area = c + warp.square_to_uniform_sphere(sample2) * r[..., None]
    d_in = p_area - ref_p
    dist_in = fr.norm(d_in)
    d_in = d_in / torch.clamp_min(dist_in, 1e-9)[..., None]
    n_in = fr.normalize(p_area - c)
    pdf_in = dist_in * dist_in / torch.clamp_min(
        torch.abs(fr.dot(d_in, n_in)) * 4.0 * m.Pi * r * r, 1e-9)
    o3 = outside[..., None]
    return DirectionSample(
        p=torch.where(o3, p_hit, p_area), n=torch.where(o3, n_hit, n_in),
        uv=torch.zeros((n, 2), device=ref_p.device),
        d=torch.where(o3, d, d_in), dist=torch.where(outside, dist, dist_in),
        pdf=torch.where(outside, pdf_cone, pdf_in),
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
    # p, n and uv are an area or sphere light's alone: the other types
    # carry these very tensors, which `where` passes through without a
    # select
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
        if t == EMITTER_SPHERE:
            ds = _sample_sphere(em, ref_p, e_idx, sample2).where(
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


def pdf_emitter_direction(em: EmitterTable, geo, ref_p,
                          ds: DirectionSample):
    """Solid-angle density [N] of sample_emitter_direction producing ds
    from ref_p [N, 3] (0 for delta emitters): an area light's reads ds.d,
    ds.dist and the light's normal ds.n; a sphere light's the cone it
    subtends from ref_p, or, from inside it, its area density. Only the
    sphere light's branch reads ref_p, which may be None in a table
    without one. geo is the scene's Geometry, as in
    `sample_emitter_direction` (no branch reads it)."""
    e_c = torch.clamp_min(ds.emitter_idx, 0)
    etype = em.etype[e_c]
    pdf = torch.zeros(ds.d.shape[0], device=ds.d.device)
    if EMITTER_AREA in em.present_types:
        cos_l = -fr.dot(ds.d, ds.n)
        area = torch.clamp_min(take_rows(em.area, e_c), 1e-12)
        p = torch.where(cos_l > 0, ds.dist * ds.dist / (
            torch.clamp_min(cos_l, 1e-9) * area), 0.0)
        pdf = torch.where(etype == EMITTER_AREA, p, pdf)
    if EMITTER_CONSTANT in em.present_types:
        pdf = torch.where(etype == EMITTER_CONSTANT, m.InvFourPi, pdf)
    if EMITTER_SPHERE in em.present_types:
        _, r, dc, cos_max = _sphere_cone(em, ref_p, e_c)
        p = torch.where(
            dc > r,
            1.0 / torch.clamp_min(2.0 * m.Pi * (1.0 - cos_max), 1e-9),
            ds.dist * ds.dist / torch.clamp_min(
                torch.abs(fr.dot(ds.d, ds.n)) * 4.0 * m.Pi * r * r, 1e-9))
        pdf = torch.where(etype == EMITTER_SPHERE, p, pdf)
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
