"""Camera wavefront, MIS weight and the render pass loop.

One pass renders width x height x spp_per_pass lanes in scanline pixel
order (lane i belongs to pixel i // spp_per_pass), so the box-filter film
splat is a reshape and a sum."""
from __future__ import annotations

import time

import torch

from ..config import RenderConfig, RGB
from ..core.rng import DIM_CAMERA, Sampler
from ..librender.film import ImageBlock
from ..librender.records import Ray


def sample_rays(scene, sampler: Sampler, width, height, spp_pass):
    """The camera wavefront for the sampler's lanes (independent sampler,
    scanline order): sample id s renders pixel s // spp_pass, so lanes may
    be any set of sample ids. Returns (ray, uv)."""
    pix = sampler.lane // spp_pass
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    jitter = sampler.next_2d(DIM_CAMERA)
    uv = torch.stack([(px + jitter[..., 0]) / width,
                      (py + jitter[..., 1]) / height], dim=-1)
    o, d = scene.sensor.sample_ray(uv)
    return Ray.create(o, d), uv


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2) in the overflow-free ratio form
    1 / (1 + (b/a)^2); non-finite pdfs count as 0."""
    a = torch.where(torch.isfinite(pdf_a), pdf_a, 0.0)
    b = torch.where(torch.isfinite(pdf_b), pdf_b, 0.0)
    a_ok = a > 0
    r = torch.clamp(b / torch.where(a_ok, torch.clamp_min(a, 1e-30), 1.0),
                    0.0, 1e12)
    return torch.where(a_ok, 1.0 / (1.0 + r * r), 0.0)


def default_spp_per_pass(width, height, spp):
    """Cap a pass at ~2^21 lanes; a binding cap rounds down to a power of
    two."""
    cap = max(1, (1 << 21) // (width * height) or 1)
    return spp if spp <= cap else 1 << (cap.bit_length() - 1)


@torch.no_grad()
def render(scene, integrator, seed: int = 0, spp: int = 16,
           cfg: RenderConfig = RGB, spp_per_pass: int | None = None,
           stats: dict | None = None):
    """Render `spp` samples per pixel in passes; returns [H, W, 3] on the
    scene's device. `stats`, when given, receives per-pass wall times
    (each pass ends in a device synchronisation)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    width, height = scene.sensor.resolution
    if spp_per_pass is None:
        spp_per_pass = default_spp_per_pass(width, height, spp)
    n_pass = (spp + spp_per_pass - 1) // spp_per_pass
    n = width * height * spp_per_pass
    block = ImageBlock.create(width, height, cfg.n_channels, scene.device)
    base = Sampler.create(seed, n, device=scene.device)
    pass_s = []
    for p in range(n_pass):
        t0 = time.perf_counter()
        sampler = base.fork(p)
        ray, _ = sample_rays(scene, sampler, width, height, spp_per_pass)
        values, valid = integrator.sample(scene, sampler, ray, cfg)
        block.put_ordered(values, valid, spp_per_pass)
        if stats is not None:
            if scene.device.type == "cuda":
                torch.cuda.synchronize(scene.device)
            pass_s.append(time.perf_counter() - t0)
    if stats is not None:
        stats.update(pass_s=pass_s, n_pass=n_pass, spp_per_pass=spp_per_pass,
                     lanes_per_pass=n)
    return block.develop()
