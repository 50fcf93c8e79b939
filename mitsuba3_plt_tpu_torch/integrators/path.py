"""Path tracer with next-event estimation and MIS (RGB, unpolarized).

The JAX package's `integrators/path.py::PathIntegrator`: power-heuristic
MIS between BSDF sampling and emitter sampling, a shadow ray on every
bounce, Russian roulette from rr_depth. `sample` loops over a fixed number
of bounces; every bounce runs for every lane, dead lanes included, as the
JAX scan does, so each intersection kernel launches exactly max_depth
times per pass. `sample_regen` is the regenerative wavefront: fewer lanes
than samples, each lane restarting on its next sample when its path ends,
until no lane is live. A dead lane carries the canonical far-away ray
(o = 1e8, d = +z), which misses every box.

Emitters: area lights (hit and sampled), point lights and the constant
environment (sampled by NEE, and seen by escaped rays with MIS against
`escape_pdf`). BSDFs: diffuse, rough conductor and the delta conductor and
dielectric (NEE masks their lanes off: their flags hold no Smooth lobe).
Under a polarized config `sample` runs the Mueller transport of
`stokes.PolarizedPathIntegrator` and returns S0; `sample_regen` has no
polarized form. Not ported: hide_emitters, the spectral variants.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig, RGB
from ..core import frame as fr
from ..core import math as m
from ..core.rng import Sampler, bounce_dim
from ..librender import bsdfs
from ..librender.bsdf import BSDFFlags
from ..librender.records import DirectionSample, Ray
from ..scene import emitters as em_mod
from .common import camera_rays_at, mis_weight
from .plt import _offset


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    max_depth: int = 6
    rr_depth: int = 5
    hide_emitters: bool = False

    def sample(self, scene, sampler: Sampler, ray: Ray,
               cfg: RenderConfig = RGB):
        """Radiance [N, C] of the camera rays (S0 under a polarized
        config), and the valid mask."""
        self._check_ported(scene)
        n, dev = ray.o.shape[0], ray.o.device
        if cfg.polarized:
            from .stokes import PolarizedPathIntegrator

            S = PolarizedPathIntegrator(
                max_depth=self.max_depth, rr_depth=self.rr_depth
            ).sample_stokes(scene, sampler, ray, cfg)
            return S[:, 0], torch.ones((n,), dtype=torch.bool, device=dev)
        carry = self._fresh_carry(scene, ray, cfg.n_channels)
        far_d = torch.tensor([0.0, 0.0, 1.0], device=dev)
        for b in range(self.max_depth):
            carry = self._bounce_step(scene, sampler, cfg, carry, b)
            dead = ~carry["active"]
            carry["o"] = torch.where(dead[..., None], 1e8, carry["o"])
            carry["d"] = torch.where(dead[..., None], far_d, carry["d"])
        return carry["L"], torch.ones((n,), dtype=torch.bool, device=dev)

    def _check_ported(self, scene):
        if self.hide_emitters:
            raise NotImplementedError("hide_emitters is not ported")

    @staticmethod
    def _fresh_carry(scene, ray: Ray, C: int) -> dict:
        """The bounce carry of paths that start on `ray`; prev_p, the
        previous vertex, only where a sphere light's pdf reads it."""
        n, dev = ray.o.shape[0], ray.o.device
        carry = dict(
            o=ray.o, d=ray.d, L=torch.zeros((n, C), device=dev),
            beta=torch.ones((n, C), device=dev),
            eta=torch.ones((n,), device=dev),
            active=torch.ones((n,), dtype=torch.bool, device=dev),
            prev_pdf=torch.ones((n,), device=dev),
            # depth 0 counts as delta: no MIS against the camera
            prev_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        )
        if em_mod.EMITTER_SPHERE in scene.emitters.present_types:
            carry["prev_p"] = ray.o
        return carry

    def sample_regen(self, scene, seed: int, width, height, spp_pass,
                     cfg: RenderConfig, n_lanes: int,
                     pixel_order: str = "scanline",
                     sampler_type: str = "independent",
                     stats: dict | None = None):
        """Regenerative wavefront over the width x height x spp_pass samples
        of one pass on `n_lanes` lanes.

        Lane i renders sample ids i, i + N, i + 2N, ...: when its path ends
        it banks the radiance and restarts on the next id below the total,
        at depth 0 and without MIS against the camera; a lane with no
        sample left turns into the dead ray. Every random number is the
        hash of (seed, sample id, dim) that `sample` draws, so each
        sample's value is that of the fixed-depth pass. The loop runs while
        any lane is live, which costs one host synchronisation per
        iteration; `stats["iterations"]` receives their count.
        `sampler_type` picks the camera's film jitter, as in `render`. Returns
        values [width * height * spp_pass, C] in sample-id order."""
        self._check_ported(scene)
        if cfg.polarized:
            raise NotImplementedError("sample_regen is unpolarized only")
        dev = scene.device
        total = width * height * spp_pass
        N = int(n_lanes)
        if N <= 0:
            raise ValueError(f"n_lanes must be positive, got {N}")
        Q = -(-total // N)
        C = cfg.n_channels

        def fresh(sid):
            return camera_rays_at(scene, seed, sid, width, height, spp_pass,
                                  pixel_order, sampler_type)[0]

        sid = torch.arange(N, dtype=torch.int64, device=dev)
        depth = torch.zeros((N,), dtype=torch.int64, device=dev)
        carry = self._fresh_carry(scene, fresh(sid), C)
        # out[q * N + lane] is the sample that lane renders q-th
        out = torch.zeros((Q * N, C), device=dev)
        far_d = torch.tensor([0.0, 0.0, 1.0], device=dev)
        iterations = 0
        while bool(carry["active"].any()):
            iterations += 1
            was_active = carry["active"]
            carry = self._bounce_step(scene, Sampler.from_lanes(seed, sid),
                                      cfg, carry, depth)
            finished = was_active & ~carry["active"]
            # every sample id finishes once: one write per slot
            out[sid[finished]] = carry["L"][finished]
            more = finished & (sid + N < total)
            sid = torch.where(more, sid + N, sid)
            depth = torch.where(more, 0, depth + 1)
            ray_f = fresh(sid)
            alive = carry["active"] | more
            m3, dead3 = more[..., None], ~alive[..., None]
            nxt = dict(
                o=torch.where(dead3, 1e8,
                              torch.where(m3, ray_f.o, carry["o"])),
                d=torch.where(dead3, far_d,
                              torch.where(m3, ray_f.d, carry["d"])),
                L=torch.where(m3, 0.0, carry["L"]),
                beta=torch.where(m3, 1.0, carry["beta"]),
                eta=torch.where(more, 1.0, carry["eta"]),
                active=alive,
                prev_pdf=torch.where(more, 1.0, carry["prev_pdf"]),
                prev_delta=more | carry["prev_delta"],
            )
            if "prev_p" in carry:
                nxt["prev_p"] = torch.where(m3, ray_f.o, carry["prev_p"])
            carry = nxt
        if stats is not None:
            stats["iterations"] = iterations
        return out[:total]

    def _bounce_step(self, scene, sampler: Sampler, cfg: RenderConfig,
                     carry: dict, b) -> dict:
        """One bounce over the whole wavefront; `b`, the depth, is an int
        (`sample`) or an int64 tensor [N] (`sample_regen`). Returns the
        carry with the next ray (dead lanes still hold theirs: the caller
        replaces it)."""
        em = scene.emitters
        mats = scene.materials
        C = cfg.n_channels
        ray_d, L, beta = carry["d"], carry["L"], carry["beta"]
        si = scene.ray_intersect(Ray.create(carry["o"], ray_d))
        hit = si.valid & carry["active"]
        midx = torch.clamp_min(si.mat_idx, 0)
        has_emitters = em.count > 0

        # emitter hit (an area light seen from its front), MIS against the
        # previous bounce's BSDF pdf
        if has_emitters:
            hit_emitter = hit & (si.emitter_idx >= 0) & (
                fr.cos_theta(si.wi) > 0)
            # d and dist from the ray itself: equal to the p-difference
            # form on hits, finite on misses
            ds_hit = DirectionSample(
                p=si.p, n=si.n, uv=si.uv,
                d=ray_d, dist=torch.where(si.valid, si.t, 1.0),
                pdf=torch.zeros_like(si.t),
                delta=torch.zeros_like(si.valid), emitter_idx=si.emitter_idx,
            )
            em_pdf = torch.where(carry["prev_delta"], 0.0,
                                 em_mod.pdf_emitter_direction(
                                     em, scene.geo, carry.get("prev_p"),
                                     ds_hit))
            mis_bsdf = mis_weight(carry["prev_pdf"], em_pdf)
            e_val = em_mod.emitter_value(em, si.emitter_idx, ds_hit.d,
                                         ds_hit.dist, hit_emitter)
            L = L + beta * e_val * torch.where(hit_emitter, mis_bsdf,
                                               0.0)[..., None]

            # escaped rays see the environment, MIS against its NEE pdf
            if scene.env_emitter >= 0:
                escaped = carry["active"] & ~si.valid
                env_pdf = torch.where(carry["prev_delta"], 0.0,
                                      em_mod.escape_pdf(em, ray_d))
                mis_env = mis_weight(carry["prev_pdf"], env_pdf)
                L = L + beta * em_mod.env_value(em, ray_d) * torch.where(
                    escaped, mis_env, 0.0)[..., None]

        active_next = hit & (b + 1 < self.max_depth)

        # next-event estimation: a shadow ray on every bounce
        if has_emitters:
            u_nee1 = sampler.next_1d(bounce_dim(b, 5))
            u_nee2 = sampler.next_2d(bounce_dim(b, 3))
            smooth = (mats.flags[midx] & BSDFFlags.Smooth) != 0
            nee_active = active_next & smooth
            ds = em_mod.sample_emitter_direction(em, scene.geo, si.p, u_nee1,
                                                 u_nee2, nee_active)
            occ_ray = Ray(
                o=torch.where(nee_active[..., None],
                              _offset(si.p, si.n, ds.d), 1e8),
                d=ds.d,
                maxt=torch.where(nee_active,
                                 ds.dist * (1.0 - m.ShadowEpsilon), 0.0),
            )
            occluded = scene.ray_test(occ_ray)
            vis = nee_active & ~occluded & (ds.pdf > 0)
            wo_local = si.to_local(ds.d)
            bsdf_val = bsdfs.eval_(mats, midx, si, wo_local, C)
            bsdf_pdf = bsdfs.pdf(mats, midx, si, wo_local)
            mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            e_val = em_mod.emitter_value(em, ds.emitter_idx, ds.d, ds.dist,
                                         vis)
            contrib = beta * bsdf_val * e_val * (
                mis_em / torch.clamp_min(ds.pdf, 1e-20))[..., None]
            L = L + torch.where(vis[..., None], contrib, 0.0)

        # BSDF sampling; u1 (the lobe choice) only where a type reads it
        u1 = (sampler.next_1d(bounce_dim(b, 0)) if bsdfs.reads_u1(mats)
              else None)
        u2 = sampler.next_2d(bounce_dim(b, 1))
        bs, weight, ok = bsdfs.sample(mats, midx, si, u1, u2, C)
        beta_next = beta * weight
        eta_next = carry["eta"] * bs.eta
        wo_world = si.to_world(bs.wo)
        new_o = _offset(si.p, si.n, wo_world)
        active_next = active_next & ok & (bs.pdf > 0) & (
            torch.amax(beta_next, dim=-1) > 0)

        # Russian roulette, on the lanes whose depth has reached rr_depth
        rr_active = b + 1 >= self.rr_depth
        if torch.is_tensor(rr_active) or rr_active:
            beta_max = torch.amax(beta_next, dim=-1) * eta_next * eta_next
            rr_prob = torch.clamp_max(beta_max, 0.95)
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            rr_scale = 1.0 / torch.clamp_min(rr_prob, 1e-6)
            rr_continue = u_rr < rr_prob
            if torch.is_tensor(rr_active):
                rr_scale = torch.where(rr_active, rr_scale, 1.0)
                rr_continue = rr_continue | ~rr_active
            beta_next = beta_next * rr_scale[..., None]
            active_next = active_next & rr_continue

        is_delta = (bs.sampled_type & BSDFFlags.Delta) != 0
        live = active_next
        out = dict(
            o=new_o, d=wo_world, L=L,
            beta=torch.where(live[..., None], beta_next, beta),
            eta=torch.where(live, eta_next, carry["eta"]),
            active=live,
            prev_pdf=torch.where(live, bs.pdf, carry["prev_pdf"]),
            prev_delta=torch.where(live, is_delta, carry["prev_delta"]),
        )
        if "prev_p" in carry:
            out["prev_p"] = torch.where(live[..., None], si.p,
                                        carry["prev_p"])
        return out
