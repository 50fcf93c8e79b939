"""Polarized transport: the Mueller path tracer and the Stokes wrapper.

`PolarizedPathIntegrator` is the path tracer of `path.py` with a Mueller
throughput T [4, 4, N, C] (the layout of `librender/mueller.py`) chained
camera-first, each BSDF weight turned to world implicit bases, so the
Stokes radiance is T @ S_emitter in the implicit basis of the arriving
camera ray. `StokesIntegrator` wraps a polarized integrator (this one or
`PLTIntegrator`) and emits 15 channels: RGB and S0..S3, each RGB, the
layout of the reference fork's `stokes_to_bitmaps`; `forward_basis`
turns the Stokes basis onto the sensor's horizontal axis first (the
reference's `stokes_fw`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import RGB_POLARIZED, RenderConfig
from ..core import frame as fr
from ..core import math as m
from ..core.rng import Sampler, bounce_dim
from ..librender import bsdfs
from ..librender import mueller as mu
from ..librender.bsdf import BSDF_DIFFUSE, BSDFFlags
from ..librender.records import DirectionSample, Ray
from ..scene import emitters as em_mod
from .common import mis_weight
from .path import PathIntegrator
from .plt import _offset


def unpolarized_stokes(value):
    """Stokes [N, 4, C] of unpolarized radiance [N, C]."""
    z = torch.zeros_like(value)
    return torch.stack([value, z, z, z], dim=1)


# BSDF types of the port whose Mueller values map unpolarized light to
# unpolarized light with the scalar weight m00: of the ported types only
# the diffuse one (a depolarizer). A scene of such materials alone (and
# unpolarized emitters, which all are) has T @ S = (L_scalar, 0, 0, 0)
# exactly, so the scalar path tracer gives its Stokes image.
_S0_SEPARABLE_TYPES = frozenset({BSDF_DIFFUSE})


def depolarizer_collapse_ok(scene) -> bool:
    """Whether every material of the scene is S0-separable (host check)."""
    return set(scene.materials.present_types) <= _S0_SEPARABLE_TYPES


@dataclasses.dataclass(frozen=True)
class PolarizedPathIntegrator:
    """NEE + MIS path tracer with a Mueller throughput. `force_full` runs
    the Mueller transport on a scene that would collapse."""

    max_depth: int = 6
    rr_depth: int = 5
    force_full: bool = False

    def sample_stokes(self, scene, sampler: Sampler, ray: Ray,
                      cfg: RenderConfig = RGB_POLARIZED):
        """Stokes radiance [N, 4, C] in the basis stokes_basis(-ray.d)."""
        if not cfg.polarized:
            raise ValueError("sample_stokes needs a polarized config")
        if not self.force_full and depolarizer_collapse_ok(scene):
            L, _ = PathIntegrator(max_depth=self.max_depth,
                                  rr_depth=self.rr_depth).sample(
                scene, sampler, ray, dataclasses.replace(cfg, polarized=False))
            return unpolarized_stokes(L)
        n, dev = ray.o.shape[0], ray.o.device
        C = cfg.n_channels
        carry = dict(
            o=ray.o, d=ray.d, L=torch.zeros((4, n, C), device=dev),
            T=mu.identity((n, C), dev),
            eta=torch.ones((n,), device=dev),
            active=torch.ones((n,), dtype=torch.bool, device=dev),
            prev_pdf=torch.ones((n,), device=dev),
            # depth 0 counts as delta: no MIS against the camera
            prev_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        )
        if em_mod.EMITTER_SPHERE in scene.emitters.present_types:
            carry["prev_p"] = ray.o  # the previous vertex: its pdf reads it
        far_d = torch.tensor([0.0, 0.0, 1.0], device=dev)
        for b in range(self.max_depth):
            carry = self._bounce_step(scene, sampler, C, carry, b)
            dead = ~carry["active"]
            carry["o"] = torch.where(dead[..., None], 1e8, carry["o"])
            carry["d"] = torch.where(dead[..., None], far_d, carry["d"])
        return carry["L"].transpose(0, 1)

    def _bounce_step(self, scene, sampler: Sampler, C: int, carry: dict,
                     b: int) -> dict:
        """One bounce of the Mueller transport over the whole wavefront."""
        em = scene.emitters
        mats = scene.materials
        ray_d, L, T = carry["d"], carry["L"], carry["T"]
        si = scene.ray_intersect(Ray.create(carry["o"], ray_d))
        hit = si.valid & carry["active"]
        midx = torch.clamp_min(si.mat_idx, 0)
        has_emitters = em.count > 0

        # emitter hit, MIS against the previous bounce's BSDF pdf
        if has_emitters:
            hit_emitter = hit & (si.emitter_idx >= 0) & (
                fr.cos_theta(si.wi) > 0)
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
            L = L + mu.apply_unpolarized(T, e_val) * torch.where(
                hit_emitter, mis_bsdf, 0.0)[:, None]

            # escaped rays see the environment, MIS against its NEE pdf
            if scene.env_emitter >= 0:
                escaped = carry["active"] & ~si.valid
                env_pdf = torch.where(carry["prev_delta"], 0.0,
                                      em_mod.escape_pdf(em, ray_d))
                mis_env = mis_weight(carry["prev_pdf"], env_pdf)
                L = L + mu.apply_unpolarized(
                    T, em_mod.env_value(em, ray_d)) * torch.where(
                    escaped, mis_env, 0.0)[:, None]

        active_next = hit & (b + 1 < self.max_depth)

        # next-event estimation: T @ (M_world @ S_emitter)
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
            M_local = bsdfs.eval_(mats, midx, si, wo_local, C, pol=True)
            bsdf_pdf = bsdfs.pdf(mats, midx, si, wo_local)
            M_world = bsdfs.to_world_mueller(si, M_local, -wo_local, si.wi)
            mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            e_val = em_mod.emitter_value(em, ds.emitter_idx, ds.d, ds.dist,
                                         vis)
            L = L + mu.apply(T, mu.apply_unpolarized(M_world, e_val)) * (
                torch.where(vis, mis_em / torch.clamp_min(ds.pdf, 1e-20),
                            0.0)[:, None])

        # BSDF sampling; u1 (the lobe choice) only where a type reads it
        u1 = (sampler.next_1d(bounce_dim(b, 0)) if bsdfs.reads_u1(mats)
              else None)
        u2 = sampler.next_2d(bounce_dim(b, 1))
        bs, weight, ok = bsdfs.sample(mats, midx, si, u1, u2, C, pol=True)
        T_next = mu.matmul(T, bsdfs.to_world_mueller(si, weight, -bs.wo,
                                                     si.wi))
        eta_next = carry["eta"] * bs.eta
        wo_world = si.to_world(bs.wo)
        new_o = _offset(si.p, si.n, wo_world)
        thr = torch.amax(torch.abs(T_next[0, 0]), dim=-1)
        active_next = active_next & ok & (bs.pdf > 0) & (thr > 0)

        # Russian roulette on |m00| eta^2, from rr_depth
        if b + 1 >= self.rr_depth:
            rr_prob = torch.clamp_max(thr * eta_next * eta_next, 0.95)
            u_rr = sampler.next_1d(bounce_dim(b, 6))
            T_next = T_next * (1.0 / torch.clamp_min(rr_prob, 1e-6))[:, None]
            active_next = active_next & (u_rr < rr_prob)

        is_delta = (bs.sampled_type & BSDFFlags.Delta) != 0
        live = active_next
        out = dict(
            o=new_o, d=wo_world, L=L, T=mu.where(live, T_next, T),
            eta=torch.where(live, eta_next, carry["eta"]),
            active=live,
            prev_pdf=torch.where(live, bs.pdf, carry["prev_pdf"]),
            prev_delta=torch.where(live, is_delta, carry["prev_delta"]),
        )
        if "prev_p" in carry:
            out["prev_p"] = torch.where(live[..., None], si.p,
                                        carry["prev_p"])
        return out


@dataclasses.dataclass(frozen=True)
class StokesIntegrator:
    """Renders with a polarized inner integrator and emits 15 channels
    [rgb, S0.rgb, S1.rgb, S2.rgb, S3.rgb], or with `compat16` the
    reference's 16-channel layout [R, G, B, A, S0..S3]. `forward_basis`
    turns the Stokes basis onto the sensor's x axis (projected normal to
    the ray; where that projection is shorter than 1e-6 the basis stays);
    without it, and on a scene the inner path tracer collapses to the
    scalar one (a rotator fixes (s, 0, 0, 0)), the basis stays the
    implicit one of the arriving ray."""

    inner: Any = None
    forward_basis: bool = True
    compat16: bool = False

    def __post_init__(self):
        if self.inner is None:
            object.__setattr__(self, "inner", PolarizedPathIntegrator())

    @property
    def n_out_channels(self) -> int:
        return 16 if self.compat16 else 15

    @property
    def max_depth(self) -> int:
        return self.inner.max_depth

    @property
    def rr_depth(self) -> int:
        return self.inner.rr_depth

    def sample(self, scene, sampler: Sampler, ray: Ray,
               cfg: RenderConfig = RGB_POLARIZED):
        """Values [N, n_out_channels] and the valid mask."""
        n, dev = ray.o.shape[0], ray.o.device
        S = self.inner.sample_stokes(
            scene, sampler, ray, dataclasses.replace(cfg, polarized=True))
        collapsed = (isinstance(self.inner, PolarizedPathIntegrator)
                     and depolarizer_collapse_ok(scene))
        if self.forward_basis and not collapsed:
            forward = -ray.d
            cur = mu.stokes_basis(forward)
            x_axis = scene.sensor.to_world[:3, 0]
            tgt = x_axis[None, :] - forward * fr.dot(
                x_axis[None, :], forward)[..., None]
            tgt_len = fr.norm(tgt)[..., None]
            tgt = torch.where(tgt_len < 1e-6, cur,
                              tgt / torch.clamp_min(tgt_len, 1e-12))
            R = mu.rotate_stokes_basis(forward, cur, tgt)
            S = mu.apply(R[..., None], S.transpose(0, 1)).transpose(0, 1)
        rgb = S[:, 0, :]
        parts = [rgb, S.reshape(n, -1)]
        if self.compat16:
            parts.insert(1, torch.ones((n, 1), device=dev))
        return torch.cat(parts, dim=-1), torch.ones((n,), dtype=torch.bool,
                                                    device=dev)
