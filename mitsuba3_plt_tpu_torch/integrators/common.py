"""Camera wavefront, MIS weight and the render pass loop.

One pass renders width x height x spp_per_pass samples. Sample id s
belongs to pixel slot s // spp_per_pass, so the box-filter film splat is a
reshape and a sum, and another filter's a sum per tap shifted by the tap
(`librender/film.py`). A slot is the scanline pixel of the same index or, in
Morton order (power-of-two square images), the pixel whose interleaved
(x, y) bits spell the slot index: consecutive lanes then cover square
image blocks instead of scanline strips."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import RenderConfig, RGB
from ..core import rng
from ..core.device import fp32_matmul
from ..core.rng import DIM_CAMERA, Sampler
from ..librender.film import FILTER_BOX, ImageBlock, filter_id
from ..librender.records import Ray


def _check_morton(width, height):
    if width != height or width & (width - 1):
        raise ValueError("pixel_order='morton' needs a power-of-two square "
                         f"resolution, got {width}x{height}")


def _morton_compact(x):
    """Every other bit of x (bits 0, 2, 4, ...) packed together; x is an
    int64 tensor or a numpy integer array below 2^32."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def morton_pixel_of(pix, width):
    """Scanline pixel index of Morton slot `pix` (int64 tensor or numpy
    array)."""
    return _morton_compact(pix >> 1) * width + _morton_compact(pix)


def morton_pixel_perm(width, height):
    """[W*H] int64 numpy permutation: mp[j] is the scanline pixel of Morton
    slot j (to unscramble slot-ordered output)."""
    _check_morton(width, height)
    return morton_pixel_of(np.arange(width * height, dtype=np.int64), width)


def _pixel_jitter(sampler: Sampler, pix, spp_pass, sampler_type):
    """The film jitter [N, 2] of each lane's sample within its pixel: the
    independent sampler's camera dimensions, or, with more than one sample
    a pixel, point s % spp_pass of a pattern keyed on (seed, pixel) of the
    stratified / multijitter (CMJ), ldsampler, halton or orthogonal
    sampler."""
    if sampler_type not in rng.SAMPLER_TYPES:
        raise ValueError(f"unknown sampler_type {sampler_type!r}; one of "
                         f"{rng.SAMPLER_TYPES}")
    if sampler_type == rng.SAMPLER_INDEPENDENT or spp_pass <= 1:
        return sampler.next_2d(DIM_CAMERA)
    s_idx = sampler.lane % spp_pass
    pattern = rng.hash_combine(sampler.seed, pix)
    if sampler_type in (rng.SAMPLER_STRATIFIED, rng.SAMPLER_MULTIJITTER):
        return rng.cmj_sample_2d(s_idx, spp_pass, pattern)
    if sampler_type == rng.SAMPLER_LD:
        return rng.ld_2d(s_idx, pattern)
    if sampler_type == rng.SAMPLER_HALTON:
        return rng.halton_2d(s_idx, pattern)
    return rng.orthogonal_2d(s_idx, spp_pass, pattern)


def camera_rays_at(scene, seed, sample_lane, width, height, spp_pass,
                   pixel_order: str = "scanline",
                   sampler_type: str = "independent"):
    """Camera rays for explicit sample ids: sample id s renders pixel slot
    s // spp_pass, whatever lane holds it, so the regenerative wavefront
    can restart a lane on a new sample and get the value the fixed-depth
    pass gets. `pixel_order` ("scanline" or "morton") maps slots to
    pixels; the sample stream is keyed on the sample id alone.
    `sampler_type` picks the film jitter (`_pixel_jitter`); the aperture
    sample is dimension DIM_CAMERA + 2, drawn where the sensor reads it.
    Returns (ray, uv)."""
    if pixel_order not in ("scanline", "morton"):
        raise ValueError(f"unknown pixel_order {pixel_order!r}")
    sampler = Sampler.from_lanes(seed, sample_lane)
    pix = sampler.lane // spp_pass
    if pixel_order == "morton":
        _check_morton(width, height)
        pix = morton_pixel_of(pix, width)
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    jitter = _pixel_jitter(sampler, pix, spp_pass, sampler_type)
    uv = torch.stack([(px + jitter[..., 0]) / width,
                      (py + jitter[..., 1]) / height], dim=-1)
    sensor = scene.sensor
    aperture = (sampler.next_2d(DIM_CAMERA + 2) if sensor.reads_aperture
                else None)
    o, d = sensor.sample_ray(uv, aperture)
    return Ray.create(o, d), uv


def sample_rays(scene, sampler: Sampler, width, height, spp_pass,
                pixel_order: str = "scanline",
                sampler_type: str = "independent"):
    """The camera wavefront for the sampler's lanes: (ray, uv)."""
    return camera_rays_at(scene, sampler.seed, sampler.lane, width, height,
                          spp_pass, pixel_order, sampler_type)


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
@fp32_matmul()
def render(scene, integrator, seed: int = 0, spp: int = 16,
           cfg: RenderConfig = RGB, spp_per_pass: int | None = None,
           stats: dict | None = None, regen: bool = False,
           pixel_order: str = "scanline", n_out_channels: int | None = None,
           rfilter=FILTER_BOX, sampler_type: str = "independent",
           timeout: float | None = None, progress=None):
    """Render `spp` samples per pixel in passes; returns [H, W, C] on the
    scene's device, C = n_out_channels, by default the integrator's own
    (15 or 16 for `StokesIntegrator`) or else the config's 3. `stats`,
    when given, receives per-pass wall times (each pass ends in a device
    synchronisation).

    `regen=True` takes the integrator's regenerative wavefront
    (`sample_regen`) where it has one and a pass holds at least 65,536
    samples, on ceil(samples / 8) lanes: a lane whose path ends restarts on
    its next sample instead of idling to the last bounce. Per-sample values
    are those of the fixed-depth pass; a polarized config ignores it.
    `pixel_order="morton"` renders the slots in Morton order and
    unscrambles the film at the end (the layout the JAX package's mesh
    bench feeds `sample_regen`).

    `rfilter` (a `librender.film` filter id or name) reconstructs through
    the box (`put_ordered`) or, any other, through `put_ordered_filtered`
    on each sample's film position; a non-box filter in Morton order
    raises ValueError, since its taps shift in scanline pixel space.
    `sampler_type` picks the camera's film jitter (`camera_rays_at`).

    `timeout` (seconds) stops between passes once the passes so far took
    longer, and develops the passes done; `progress(done, total,
    elapsed_s)` is called after each pass. With either, or with `stats`,
    each pass ends in a device synchronisation. `stats` then also
    receives passes_done, spp_done, total_s, compile_s (the first pass's
    seconds, the kernels' build and first launches included) and
    steady_s_per_pass (the mean of the later passes; None after one).

    The render's matrix products take full float32 (`fp32_matmul`): the
    caller's TF32 flags are switched off for the call and restored."""
    rfilter = filter_id(rfilter)
    if rfilter != FILTER_BOX and pixel_order == "morton":
        raise ValueError("pixel_order='morton' takes only the box filter: "
                         "a filter's taps shift in scanline pixel space")
    width, height = scene.sensor.resolution
    if spp_per_pass is None:
        spp_per_pass = default_spp_per_pass(width, height, spp)
    n_pass = (spp + spp_per_pass - 1) // spp_per_pass
    n = width * height * spp_per_pass
    use_regen = (regen and hasattr(integrator, "sample_regen")
                 and not cfg.polarized and n >= 1 << 16)
    regen_lanes = -(-n // 8)
    n_out_channels = n_out_channels or getattr(integrator, "n_out_channels",
                                               cfg.n_channels)
    block = ImageBlock.create(width, height, n_out_channels, scene.device,
                              rfilter)
    base = Sampler.create(seed, n, device=scene.device)
    pass_s, regen_iterations = [], []
    timed = stats is not None or timeout is not None or progress is not None
    t_start = time.perf_counter()
    for p in range(n_pass):
        t0 = time.perf_counter()
        sampler = base.fork(p)
        if use_regen:
            info = {}
            values = integrator.sample_regen(
                scene, sampler.seed, width, height, spp_per_pass, cfg,
                regen_lanes, pixel_order=pixel_order,
                sampler_type=sampler_type, stats=info)
            valid = torch.ones((n,), dtype=torch.bool, device=scene.device)
            regen_iterations.append(info["iterations"])
            # the slots' film positions, from the camera wavefront
            uv = (None if rfilter == FILTER_BOX else sample_rays(
                scene, sampler, width, height, spp_per_pass, pixel_order,
                sampler_type)[1])
        else:
            ray, uv = sample_rays(scene, sampler, width, height,
                                  spp_per_pass, pixel_order, sampler_type)
            values, valid = integrator.sample(scene, sampler, ray, cfg)
        if rfilter == FILTER_BOX:
            block.put_ordered(values, valid, spp_per_pass)
        else:
            block.put_ordered_filtered(uv, values, valid, spp_per_pass)
        if timed:
            if scene.device.type == "cuda":
                torch.cuda.synchronize(scene.device)
            pass_s.append(time.perf_counter() - t0)
            elapsed = time.perf_counter() - t_start
            if progress is not None:
                progress(p + 1, n_pass, elapsed)
            if timeout is not None and elapsed > timeout:
                break
    if stats is not None:
        done = len(pass_s)
        stats.update(pass_s=pass_s, n_pass=n_pass, spp_per_pass=spp_per_pass,
                     lanes_per_pass=regen_lanes if use_regen else n,
                     regen_iterations=regen_iterations, passes_done=done,
                     spp_done=done * spp_per_pass,
                     total_s=time.perf_counter() - t_start,
                     compile_s=pass_s[0],
                     steady_s_per_pass=(sum(pass_s[1:]) / (done - 1)
                                        if done > 1 else None))
    if pixel_order == "morton":
        # slot order -> scanline order: pixel mp[j] was rendered in slot j
        inv = np.empty(width * height, np.int64)
        inv[morton_pixel_perm(width, height)] = np.arange(width * height)
        block.data = block.data[torch.as_tensor(inv, device=scene.device)]
    return block.develop()
