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

Under a polarized config the prefix weight is a Mueller matrix [4, 4, N,
C] chained camera-first, alpha <- alpha @ W_world, each replay weight
turned to world implicit bases; the emissive term is alpha @ (e, 0, 0, 0)
and the NEE term alpha @ (M_world @ (e / pdf, 0, 0, 0)), and the result
a Stokes vector [N, 4, C] in the implicit basis of the arriving camera
ray (`sample_stokes`; `sample` keeps S0). The roulette reads the
weight's m00.

The beam (`plt/beam.py`) is sourced and measured by `source_beam`,
`measure` and `measured_beam`. A render does not call them: `measure`
returns the replayed radiance unchanged (every sensor responds to
intensity), so the beam would be work whose result nothing reads, which
the JAX package's compiler drops as dead code.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RGB, RGB_POLARIZED, RenderConfig
from ..core import frame as fr
from ..core import math as m
from ..core import spectrum as spec
from ..core.rng import DIM_WAVELENGTH, Sampler, bounce_dim
from ..librender import bsdfs
from ..librender import mueller as mu
from ..librender.bsdf import BSDFFlags
from ..librender.records import DirectionSample, Ray, detached
from ..plt import wbsdf as wb
from ..plt.beam import PLTBeam
from ..scene import emitters as em_mod
from .common import mis_weight


# the beam's sourcing (the JAX integrator's defaults): an area light's
# area, a distant emitter's solid angle, and the widest angular spread
EMISSIVE_SOURCING_AREA = 1e-4
DISTANT_SOURCING_AREA = 1e-7
MAX_ANGULAR_SPREAD = 1e-7


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
        """Radiance [N, C] of the camera rays (S0 under a polarized
        config), and the valid mask."""
        n, dev = ray.o.shape[0], ray.o.device
        L = self._sample_impl(scene, sampler, ray, cfg)
        if cfg.polarized:
            L = L[:, 0]
        return L, torch.ones((n,), dtype=torch.bool, device=dev)

    def sample_stokes(self, scene, sampler: Sampler, ray: Ray,
                      cfg: RenderConfig = RGB_POLARIZED):
        """Stokes radiance [N, 4, C] in the implicit basis of the arriving
        camera ray, stokes_basis(-ray.d)."""
        if not cfg.polarized:
            raise ValueError("sample_stokes needs a polarized config")
        return self._sample_impl(scene, sampler, ray, cfg)

    def _sample_impl(self, scene, sampler: Sampler, ray: Ray,
                     cfg: RenderConfig):
        n, dev = ray.o.shape[0], ray.o.device
        C = cfg.n_channels
        pol = cfg.polarized
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
        if pol:
            alpha = mu.identity((n, C), dev)
            L = torch.zeros((4, n, C), device=dev)
        else:
            alpha = torch.ones((n, C), device=dev)
            L = torch.zeros((n, C), device=dev)
        for b in range(self.max_depth):
            # detached sampling, as the JAX package's fused scan: the
            # interaction, the sample, its lobe and its weight carry no
            # gradient (nor, through the weight, does the roulette); the
            # parameters differentiate through the emitter values, the
            # wave eval and the replay weight
            si = detached(scene.ray_intersect(Ray.create(ray_o, ray_d)))
            hit = si.valid & active
            is_emitter = hit & (si.emitter_idx >= 0)
            midx = torch.clamp_min(si.mat_idx, 0)

            u1 = (sampler.next_1d(bounce_dim(b, 0))
                  if bsdfs.reads_u1(mats) else None)
            u2 = sampler.next_2d(bounce_dim(b, 1))
            lobe_u2 = sampler.next_2d(bounce_dim(b, 3))
            sd, weight, ok = wb.wbsdf_sample(mats, midx, si, u1, u2, lobe_u2,
                                             wl, pol)
            sd, weight = detached(sd), weight.detach()
            bs = sd.bs

            active_next = hit & (b + 1 < self.max_depth) & ok & (bs.pdf > 0)
            rr_rcp = None
            if b + 1 >= self.rr_depth:  # Russian roulette
                w_rr = weight[0, 0] if pol else weight
                rr_prob = torch.clamp(torch.amax(w_rr, dim=-1), 0.05, 0.95)
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
            w_rep = wb.wbsdf_weight(mats, midx, si, bs.wo, sd, pol)
            if pol:
                # camera-first chain, the replay weight in world bases
                W = bsdfs.to_world_mueller(si, w_rep, -bs.wo, si.wi)
                if rr_rcp is not None:
                    W = W * rr_rcp[:, None]
                alpha = mu.where(hit, mu.matmul(alpha, W), alpha)
            else:
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
        return L.transpose(0, 1) if pol else L

    def _emissive_term(self, scene, si, hit, is_emitter, last_nd_pdf, prev_p,
                       prev_delta, alpha):
        """Emissive-hit replay with MIS against the last non-delta pdf;
        prev_p / prev_delta describe the previous path vertex (the sensor
        for the first bounce). The detector measures intensity, so the
        measured value is the replayed radiance. A Mueller alpha [4, 4,
        N, C] gives the Stokes term alpha @ (e, 0, 0, 0) [4, N, C]."""
        em = scene.emitters
        active = hit & is_emitter & (fr.cos_theta(si.wi) > 0)
        to_hit = si.p - prev_p
        ds = DirectionSample(
            p=si.p, n=si.n, uv=si.uv,
            d=fr.normalize(to_hit), dist=fr.norm(to_hit),
            pdf=torch.zeros_like(si.t),
            delta=torch.zeros_like(si.valid), emitter_idx=si.emitter_idx,
        )
        em_pdf = torch.where(prev_delta, 0.0, em_mod.pdf_emitter_direction(
            em, scene.geo, prev_p, ds))
        mis_bsdf = mis_weight(last_nd_pdf, em_pdf)
        e_val = em_mod.emitter_value(em, si.emitter_idx, ds.d, ds.dist,
                                     active)
        if alpha.dim() == 4:
            w = torch.where(active, mis_bsdf, 0.0)
            return mu.apply_unpolarized(alpha, e_val) * w[:, None]
        contrib = e_val * alpha * mis_bsdf[..., None]
        return torch.where(active[..., None], contrib, 0.0)

    def source_beam(self, em, si, d, dist, Le):
        """The beam sourced at the emitter that si hit, seen along d from
        dist away: a distant emitter's (directional, constant) of solid
        angle DISTANT_SOURCING_AREA, an area light's of area
        EMISSIVE_SOURCING_AREA at si.p."""
        n, dev = d.shape[0], d.device
        etype = em.etype[torch.clamp_min(si.emitter_idx, 0)]
        is_distant = ((etype == em_mod.EMITTER_DIRECTIONAL)
                      | (etype == em_mod.EMITTER_CONSTANT))
        beam_d = PLTBeam.source_distant(
            d, torch.full((n,), DISTANT_SOURCING_AREA, device=dev), Le,
            MAX_ANGULAR_SPREAD)
        beam_a = PLTBeam.source_area(
            si.p, d, torch.full((n,), EMISSIVE_SOURCING_AREA, device=dev),
            dist, Le, MAX_ANGULAR_SPREAD)
        return beam_d.where(is_distant, beam_a)

    def measure(self, beam, sensor_p, Li, sensor=None):
        """The measured value of radiance Li that arrives with `beam` at
        sensor_p: Li itself. The sensors respond to intensity, the
        projection of the generalized Stokes vector onto S0; the beam's
        mutual coherence enters only where amplitudes superpose, inside
        the wave eval's lobe sum."""
        self.measured_beam(beam, sensor_p, sensor)
        return Li

    def measured_beam(self, beam, sensor_p, sensor=None):
        """The beam at the sensor: propagated to sensor_p, its Stokes basis
        turned onto the sensor's horizontal axis when a sensor is given."""
        beam = beam.propagate(sensor_p)
        if sensor is not None:
            x_axis = sensor.to_world[:3, 0]
            fwd = -beam.dir
            tgt = x_axis[None, :] - fwd * torch.sum(
                x_axis[None, :] * fwd, dim=-1, keepdim=True)
            tlen = fr.norm(tgt)[..., None]
            ok = tlen[..., 0] > 1e-6
            tgt = torch.where(ok[..., None],
                              tgt / torch.clamp_min(tlen, 1e-12),
                              beam.tangent)
            beam = beam.rotate_frame(tgt)
        return beam
    def _nee_term(self, scene, sampler, si, hit, bs, b, alpha, sd,
                  rgb_colour):
        """Next-event estimation at bounce b with the wave eval and MIS
        ([N, C], or Stokes [4, N, C] for a Mueller alpha)."""
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
        pol = alpha.dim() == 4
        bsdf_val = wb.wbsdf_eval(mats, midx, si, wo_local, sd,
                                 rgb_colour=rgb_colour, pol=pol)
        bsdf_pdf = wb.wbsdf_pdf(mats, midx, si, wo_local, sd)
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
        e_val = em_mod.emitter_value(em, ds.emitter_idx, ds.d, ds.dist, vis)
        em_weight = e_val / torch.clamp_min(ds.pdf, 1e-20)[..., None]
        if pol:
            # alpha @ (M_world @ (e / pdf, 0, 0, 0)): two matrix-vector
            # products
            M_world = bsdfs.to_world_mueller(si, bsdf_val, -wo_local, si.wi)
            S = mu.apply(alpha, mu.apply_unpolarized(M_world, em_weight))
            return S * torch.where(vis, mis_em, 0.0)[:, None]
        contrib = em_weight * bsdf_val * alpha * mis_em[..., None]
        return torch.where(vis[..., None], contrib, 0.0)
