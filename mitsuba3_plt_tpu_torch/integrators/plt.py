"""PLT integrator: wave transport as one fused walk over the bounces.

Because the replay weights do not depend on coherence, the prefix product
alpha_i = prod_{j<i} wbsdf_weight_j is a running product available while
the path is sampled, so each bounce adds its emissive-hit and NEE terms in
the same loop that samples the path (no stacked bounce buffer). Every
bounce runs for every lane, dead lanes included, as a fixed-length scan
does: each of the four kernels launches exactly once per bounce.

RGB mode samples its own per-channel wavelengths in
[CIE_MIN, CIE_MAX - 150] nm; each contributes its sRGB colour in the wave
eval. Russian-roulette survival is compensated in the prefix weight.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig, RGB
from ..core import frame as fr
from ..core import math as m
from ..core import spectrum as spec
from ..core.rng import DIM_WAVELENGTH, Sampler, bounce_dim
from ..librender import bsdfs
from ..librender.bsdf import BSDFFlags
from ..librender.records import DirectionSample, Ray
from ..plt import wbsdf as wb
from ..scene import emitters as em_mod
from .common import mis_weight


def _offset(p, n, d):
    """Ray origin p pushed off the surface along n toward d's side."""
    return p + n * torch.where(fr.dot(d, n) >= 0, m.RayEpsilon,
                               -m.RayEpsilon)[..., None]


@dataclasses.dataclass(frozen=True)
class PLTIntegrator:
    max_depth: int = 8
    rr_depth: int = 4

    def sample(self, scene, sampler: Sampler, ray: Ray,
               cfg: RenderConfig = RGB):
        """Radiance [N, C] of the camera rays, and the valid mask."""
        n, dev = ray.o.shape[0], ray.o.device
        C = cfg.n_channels
        mats = scene.materials
        u_wl = torch.stack([sampler.next_1d(DIM_WAVELENGTH + i)
                            for i in range(C)], dim=-1)
        wl = wb.sample_plt_wavelengths(u_wl)
        # the sampled wavelengths are loop-invariant: colour them once
        rgb_colour = spec.xyz_to_srgb(spec.cie1931_xyz(wl))

        ray_o, ray_d = ray.o, ray.d
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        last_nd_pdf = torch.ones((n,), device=dev)
        prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_p = torch.zeros((n, 3), device=dev)
        alpha = torch.ones((n, C), device=dev)
        L = torch.zeros((n, C), device=dev)
        for b in range(self.max_depth):
            si = scene.ray_intersect(Ray.create(ray_o, ray_d))
            hit = si.valid & active
            is_emitter = hit & (si.emitter_idx >= 0)
            midx = torch.clamp_min(si.mat_idx, 0)

            u1 = (sampler.next_1d(bounce_dim(b, 0))
                  if bsdfs.reads_u1(mats) else None)
            u2 = sampler.next_2d(bounce_dim(b, 1))
            lobe_u2 = sampler.next_2d(bounce_dim(b, 3))
            sd, weight, ok = wb.wbsdf_sample(mats, midx, si, u1, u2, lobe_u2,
                                             wl)
            bs = sd.bs

            active_next = hit & (b + 1 < self.max_depth) & ok & (bs.pdf > 0)
            rr_rcp = None
            if b + 1 >= self.rr_depth:  # Russian roulette
                rr_prob = torch.clamp(torch.amax(weight, dim=-1), 0.05, 0.95)
                u_rr = sampler.next_1d(bounce_dim(b, 6))
                active_next = active_next & (u_rr < rr_prob)
                rr_rcp = 1.0 / torch.clamp_min(rr_prob, 1e-6)
            is_delta = (bs.sampled_type & BSDFFlags.Delta) != 0

            # solve terms for this prefix
            prev_p_eff = si.p + si.to_world(si.wi) if b == 0 else prev_p
            L = (L + self._emissive_term(scene, si, hit, is_emitter,
                                         last_nd_pdf, prev_p_eff, prev_delta,
                                         alpha)
                 + self._nee_term(scene, sampler, si, hit, bs, b, alpha, sd,
                                  rgb_colour))

            # running replay weight
            w_rep = wb.wbsdf_weight(mats, midx, si, bs.wo, sd)
            if rr_rcp is not None:
                w_rep = w_rep * rr_rcp[..., None]
            alpha = alpha * torch.where(hit[..., None], w_rep, 1.0)

            wo_world = si.to_world(bs.wo)
            new_o = _offset(si.p, si.n, wo_world)
            # canonical far-away ray for dead lanes
            dead = ~active_next
            ray_o = torch.where(dead[..., None], 1e8, new_o)
            ray_d = torch.where(
                dead[..., None], torch.tensor([0.0, 0.0, 1.0], device=dev),
                wo_world)
            nd_pdf_next = torch.where(is_delta, last_nd_pdf, bs.pdf)
            last_nd_pdf = torch.where(active_next, nd_pdf_next, last_nd_pdf)
            active = active_next
            prev_delta = is_delta
            prev_p = si.p
        return L, torch.ones((n,), dtype=torch.bool, device=dev)

    def _emissive_term(self, scene, si, hit, is_emitter, last_nd_pdf, prev_p,
                       prev_delta, alpha):
        """Emissive-hit replay with MIS against the last non-delta pdf;
        prev_p / prev_delta describe the previous path vertex (the sensor
        for the first bounce). The detector measures intensity, so the
        measured value is the replayed radiance."""
        em = scene.emitters
        active = hit & is_emitter & (fr.cos_theta(si.wi) > 0)
        to_hit = si.p - prev_p
        ds = DirectionSample(
            p=si.p, n=si.n, uv=si.uv,
            d=fr.normalize(to_hit), dist=fr.norm(to_hit),
            pdf=torch.zeros_like(si.t),
            delta=torch.zeros_like(si.valid), emitter_idx=si.emitter_idx,
        )
        em_pdf = torch.where(prev_delta, 0.0,
                             em_mod.pdf_emitter_direction(em, ds))
        mis_bsdf = mis_weight(last_nd_pdf, em_pdf)
        e_val = em_mod.emitter_value(em, si.emitter_idx, ds.d, ds.dist,
                                     active)
        contrib = e_val * alpha * mis_bsdf[..., None]
        return torch.where(active[..., None], contrib, 0.0)

    def _nee_term(self, scene, sampler, si, hit, bs, b, alpha, sd,
                  rgb_colour):
        """Next-event estimation at bounce b with the wave eval and MIS."""
        em = scene.emitters
        mats = scene.materials
        smooth = (bs.sampled_type & BSDFFlags.Smooth) != 0
        active_em = hit & smooth
        u1 = sampler.next_1d(bounce_dim(b, 8))
        u2 = sampler.next_2d(bounce_dim(b, 9))
        ds = em_mod.sample_emitter_direction(em, scene.geo, si.p, u1, u2,
                                             active_em)

        # shadow ray (inactive lanes get the canonical dead ray)
        occ_ray = Ray(
            o=torch.where(active_em[..., None], _offset(si.p, si.n, ds.d),
                          1e8),
            d=ds.d,
            maxt=torch.where(active_em, ds.dist * (1.0 - m.ShadowEpsilon),
                             0.0),
        )
        occluded = scene.ray_test(occ_ray)
        vis = active_em & ~occluded & (ds.pdf > 0)

        midx = torch.clamp_min(si.mat_idx, 0)
        wo_local = si.to_local(ds.d)
        bsdf_val = wb.wbsdf_eval(mats, midx, si, wo_local, sd,
                                 rgb_colour=rgb_colour)
        bsdf_pdf = wb.wbsdf_pdf(mats, midx, si, wo_local, sd)
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
        e_val = em_mod.emitter_value(em, ds.emitter_idx, ds.d, ds.dist, vis)
        em_weight = e_val / torch.clamp_min(ds.pdf, 1e-20)[..., None]
        contrib = em_weight * bsdf_val * alpha * mis_em[..., None]
        return torch.where(vis[..., None], contrib, 0.0)
