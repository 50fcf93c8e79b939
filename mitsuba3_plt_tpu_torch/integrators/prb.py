"""Path-replay backpropagation (PRB): the JAX package's
`integrators/prb.py` (after the reference's ad/integrators/prb.py).

One forward value whose autograd gradient is the PRB gradient:

  phase 1, under torch.no_grad: the path tracer's walk, recording each
  bounce (the interaction, the sampled wo, the detached pdfs, MIS
  weights, roulette scale and NEE record);

  phase 2, attached: ONE batched re-evaluation over all [D x N] bounces,

    L = sum_i beta_i (Le_i mis_i + f_i E_i k_i)
      + sum_i beta_i (w_i - detach(w_i)) S_{i+1},

  with beta_i the detached throughput prefix, S_{i+1} the detached
  suffix radiance and w_i = f(si_i, wo_i) / pdf_i the attached replay
  weight. The second sum is zero-valued and carries the gradient of
  indirect light, so L's value is the detached path tracer's.

Against autograd through the path tracer: a [D, N] replay record instead
of the recomputed walk, no gradient through the sampled pdfs, and none
through intersection positions. Under a polarized config it runs the
unpolarized estimator, as the JAX package does (PRB differentiates S0).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RGB, RenderConfig
from ..core import frame as fr
from ..core import math as m
from ..core.device import fp32_matmul
from ..core.rng import Sampler, bounce_dim
from ..librender import bsdfs
from ..librender.bsdf import BSDFFlags
from ..librender.records import DirectionSample, Ray, SurfaceInteraction
from ..scene import emitters as em_mod
from .common import mis_weight
from .plt import _offset

# the per-bounce record of phase 1, beside the interaction's fields
_RECORD = ("active", "eh_mask", "eh_d", "eh_dist", "eh_mis", "esc_mask",
           "esc_d", "esc_mis", "nee_vis", "nee_d", "nee_dist", "nee_emitter",
           "nee_k", "wo", "w_det", "pdf_rr", "is_delta")


@dataclasses.dataclass(frozen=True)
class PRBIntegrator:
    """Drop-in integrator whose `sample` is PRB-differentiable."""

    max_depth: int = 6
    rr_depth: int = 5

    @torch.no_grad()
    def _record(self, scene, sampler: Sampler, ray: Ray, C: int):
        """Phase 1: the detached walk. Returns (the interactions, the
        record), each a dict of tensors stacked [D, N, ...]."""
        n, dev = ray.o.shape[0], ray.o.device
        em, mats = scene.emitters, scene.materials
        has_emitters = em.count > 0
        far_d = torch.tensor([0.0, 0.0, 1.0], device=dev)
        zeros1 = torch.zeros((n,), device=dev)
        zeros3 = torch.zeros((n, 3), device=dev)
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        ray_o, ray_d = ray.o, ray.d
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((n,), device=dev)
        prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
        # the previous vertex, read by a sphere light's pdf alone
        track_p = em_mod.EMITTER_SPHERE in em.present_types
        prev_p = ray.o if track_p else None
        sis, recs = [], []
        for b in range(self.max_depth):
            si = scene.ray_intersect(Ray.create(ray_o, ray_d))
            hit = si.valid & active
            midx = torch.clamp_min(si.mat_idx, 0)
            rec = dict(eh_mask=no, eh_mis=zeros1, esc_mask=no,
                       esc_mis=zeros1, eh_d=ray_d,
                       eh_dist=torch.where(si.valid, si.t, 1.0),
                       esc_d=ray_d)
            if has_emitters:
                rec["eh_mask"] = hit & (si.emitter_idx >= 0) & (
                    fr.cos_theta(si.wi) > 0)
                ds_hit = DirectionSample(
                    p=si.p, n=si.n, uv=si.uv, d=ray_d, dist=rec["eh_dist"],
                    pdf=torch.zeros_like(si.t),
                    delta=torch.zeros_like(si.valid),
                    emitter_idx=si.emitter_idx)
                em_pdf = torch.where(prev_delta, 0.0,
                                     em_mod.pdf_emitter_direction(
                                         em, scene.geo, prev_p, ds_hit))
                rec["eh_mis"] = mis_weight(prev_pdf, em_pdf)
                if scene.env_emitter >= 0:
                    rec["esc_mask"] = active & ~si.valid
                    env_pdf = torch.where(prev_delta, 0.0,
                                          em_mod.escape_pdf(em, ray_d))
                    rec["esc_mis"] = mis_weight(prev_pdf, env_pdf)
            rec["active"] = active & (si.valid | rec["esc_mask"])
            active_next = hit & (b + 1 < self.max_depth)

            # the NEE record: visibility, direction and the detached
            # kernel mis / pdf
            rec.update(nee_vis=no, nee_d=zeros3, nee_dist=zeros1 + 1.0,
                       nee_emitter=torch.zeros((n,), dtype=torch.int64,
                                               device=dev),
                       nee_k=zeros1)
            if has_emitters:
                u_nee1 = sampler.next_1d(bounce_dim(b, 5))
                u_nee2 = sampler.next_2d(bounce_dim(b, 3))
                smooth = (mats.flags[midx] & BSDFFlags.Smooth) != 0
                nee_active = active_next & smooth
                ds = em_mod.sample_emitter_direction(em, scene.geo, si.p,
                                                     u_nee1, u_nee2,
                                                     nee_active)
                occ_ray = Ray(
                    o=torch.where(nee_active[..., None],
                                  _offset(si.p, si.n, ds.d), 1e8),
                    d=ds.d,
                    maxt=torch.where(nee_active,
                                     ds.dist * (1.0 - m.ShadowEpsilon), 0.0))
                vis = nee_active & ~scene.ray_test(occ_ray) & (ds.pdf > 0)
                bsdf_pdf = bsdfs.pdf(mats, midx, si, si.to_local(ds.d))
                mis_em = torch.where(ds.delta, 1.0,
                                     mis_weight(ds.pdf, bsdf_pdf))
                rec.update(nee_vis=vis, nee_d=ds.d, nee_dist=ds.dist,
                           nee_emitter=ds.emitter_idx,
                           nee_k=torch.where(vis, mis_em / torch.clamp_min(
                               ds.pdf, 1e-20), 0.0))

            # BSDF sampling, the roulette folded into w_det and pdf_rr
            u1 = (sampler.next_1d(bounce_dim(b, 0)) if bsdfs.reads_u1(mats)
                  else None)
            u2 = sampler.next_2d(bounce_dim(b, 1))
            bs, weight, ok = bsdfs.sample(mats, midx, si, u1, u2, C)
            w_max = torch.amax(weight, dim=-1)
            active_next = active_next & ok & (bs.pdf > 0) & (w_max > 0)
            rr_scale = torch.ones((n,), device=dev)
            if b + 1 >= self.rr_depth:
                rr_prob = torch.clamp_max(w_max, 0.95)
                u_rr = sampler.next_1d(bounce_dim(b, 6))
                active_next = active_next & (u_rr < rr_prob)
                rr_scale = 1.0 / torch.clamp_min(rr_prob, 1e-6)
            is_delta = (bs.sampled_type & BSDFFlags.Delta) != 0
            rec.update(wo=bs.wo, w_det=weight * rr_scale[..., None],
                       pdf_rr=bs.pdf / rr_scale, is_delta=is_delta)
            sis.append(si)
            recs.append(rec)

            wo_world = si.to_world(bs.wo)
            dead = ~active_next
            ray_o = torch.where(dead[..., None], 1e8,
                                _offset(si.p, si.n, wo_world))
            ray_d = torch.where(dead[..., None], far_d, wo_world)
            prev_pdf = torch.where(active_next, bs.pdf, prev_pdf)
            prev_delta = torch.where(active_next, is_delta, prev_delta)
            if track_p:
                prev_p = torch.where(active_next[..., None], si.p, prev_p)
            active = active_next
        si_st = {f.name: torch.stack([getattr(s, f.name) for s in sis])
                 for f in dataclasses.fields(SurfaceInteraction)
                 if getattr(sis[0], f.name) is not None}
        rec_st = {k: torch.stack([r[k] for r in recs]) for k in _RECORD}
        return si_st, rec_st

    @fp32_matmul()
    def sample(self, scene, sampler: Sampler, ray: Ray,
               cfg: RenderConfig = RGB):
        """(L [N, C], valid [N]); autograd of L is the PRB gradient. The
        walk and the re-evaluation take full float32 products
        (`fp32_matmul`)."""
        n, dev = ray.o.shape[0], ray.o.device
        C, D = cfg.n_channels, self.max_depth
        si_st, rec = self._record(scene, sampler, ray, C)

        # phase 2: one attached re-evaluation over the [D * N] bounces
        flat = lambda x: x.reshape((D * n,) + x.shape[2:])  # noqa: E731
        si_f = SurfaceInteraction(**{k: flat(v) for k, v in si_st.items()})
        r = {k: flat(v) for k, v in rec.items()}
        em, mats = scene.emitters, scene.materials
        midx = torch.clamp_min(si_f.mat_idx, 0)

        le = em_mod.emitter_value(em, si_f.emitter_idx, r["eh_d"],
                                  r["eh_dist"], r["eh_mask"])
        ce = torch.where(r["eh_mask"][..., None],
                         le * r["eh_mis"][..., None], 0.0)
        if scene.env_emitter >= 0:
            env = em_mod.env_value(em, r["esc_d"])
            ce = ce + torch.where(r["esc_mask"][..., None],
                                  env * r["esc_mis"][..., None], 0.0)

        # NEE: attached BSDF value x attached emitter value x detached k
        f_nee = bsdfs.eval_(mats, midx, si_f, si_f.to_local(r["nee_d"]), C)
        e_nee = em_mod.emitter_value(em, r["nee_emitter"], r["nee_d"],
                                     r["nee_dist"], r["nee_vis"])
        cn = torch.where(r["nee_vis"][..., None],
                         f_nee * e_nee * r["nee_k"][..., None], 0.0)

        # the attached replay weight f / detached pdf; delta lobes (whose
        # eval is 0), dead lanes and misses keep the detached weight
        f_wo = bsdfs.eval_(mats, midx, si_f, r["wo"], C)
        w_att = f_wo / torch.clamp_min(r["pdf_rr"], 1e-20)[..., None]
        keep = r["is_delta"] | ~r["active"] | ~si_f.valid
        w_att = torch.where(keep[..., None], r["w_det"], w_att)

        shape = (D, n, C)
        ce, cn, w_att = ce.reshape(shape), cn.reshape(shape), \
            w_att.reshape(shape)
        w_det = torch.where(rec["active"][..., None], rec["w_det"], 1.0)
        # detached prefixes beta_i = prod_{j<i} w_j and suffixes
        # S_i = ce_i + cn_i + w_i S_{i+1}
        beta = torch.cat([torch.ones((1, n, C), device=dev),
                          torch.cumprod(w_det, dim=0)[:-1]], dim=0)
        S_next = [torch.zeros((n, C), device=dev)]
        ce_d, cn_d = ce.detach(), cn.detach()
        for i in range(D - 1, 0, -1):
            S_next.append(ce_d[i] + cn_d[i] + w_det[i] * S_next[-1])
        S_next = torch.stack(S_next[::-1])
        L = torch.sum(beta * (ce + cn + (w_att - w_att.detach()) * S_next),
                      dim=0)
        return L, torch.ones((n,), dtype=torch.bool, device=dev)
