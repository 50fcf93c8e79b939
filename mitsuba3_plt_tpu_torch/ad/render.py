"""Gradient rendering: reverse and forward mode through the render passes.

The JAX package's `ad/render.py`: the renderer is a function of the
scene's tensors, so the gradient of a loss of the image is autograd
through the passes. What that module adds, and this one too:

  * one `torch.utils.checkpoint` a pass (non-reentrant): the pass's
    bounce intermediates are recomputed in the backward instead of kept,
    the memory role of `jax.checkpoint` (and of the reference's path
    replay). The counter-based sampler replays the same samples, so the
    recomputed pass is the same pass; its kernels launch again (each
    forward kernel twice a pass, the lobe sum's backward once);
  * detached sampling: the sampled path (which lobe, which direction, the
    hit search) carries no gradient; the parameters differentiate through
    the emitter values, BSDF evaluations and weights along it;
  * the silhouette boundary terms of the vertex rows
    (`render_loss_grad(..., geometry_boundary=True)`, `ad/projective.py`).

The lobe sum (`ops/grating.py::grating_lobe_sum`) has a VJP and no JVP,
so `render_forward` raises on a scene that reaches it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from ..config import RGB, RenderConfig
from ..core.device import fp32_matmul
from ..core.rng import Sampler
from ..integrators.common import sample_rays
from ..librender.film import FILTER_BOX, ImageBlock
from .params import traverse


def default_spp_per_pass(width, height, spp):
    """The JAX package's pass size: at most 2^19 lanes a pass."""
    return max(1, min(spp, (1 << 19) // (width * height) or 1))


def _render_pass(scene, integrator_sample, seed, pass_idx, spp_pass, cfg,
                 rfilter):
    """The film buffer [H*W, C+1] of pass `pass_idx`: its sampler is
    Sampler.create(seed, n).fork(pass_idx), the JAX package's. A non-box
    filter splats through `put_ordered_filtered`, where the JAX package
    scatters: the same sums, differentiable either way."""
    width, height = scene.sensor.resolution
    n = width * height * spp_pass
    sampler = Sampler.create(seed, n, device=scene.device).fork(pass_idx)
    ray, uv = sample_rays(scene, sampler, width, height, spp_pass)
    values, valid = integrator_sample(scene, sampler, ray, cfg)
    block = ImageBlock.create(width, height, values.shape[-1], scene.device,
                              rfilter)
    if block.rfilter == FILTER_BOX:
        return block.put_ordered(values, valid, spp_pass).data
    return block.put_ordered_filtered(uv, values, valid, spp_pass).data


@fp32_matmul()
def render_differentiable(scene, integrator_sample, seed: int = 0,
                          spp: int = 4, cfg: RenderConfig = RGB,
                          spp_per_pass: int | None = None,
                          rfilter=FILTER_BOX):
    """The image [H, W, C] as a differentiable function of the scene's
    tensors: `integrator_sample` is an integrator's `sample` (path, PLT or
    PRB), `rfilter` the film's reconstruction filter (id or name). Each
    pass is checkpointed where autograd records. The forward takes full
    float32 products (`fp32_matmul`); `render_loss_grad` and `render_grad`
    take their backward so too, and a caller who runs the backward itself
    keeps its own TF32 flags there."""
    width, height = scene.sensor.resolution
    if spp_per_pass is None:
        spp_per_pass = default_spp_per_pass(width, height, spp)
    n_pass = (spp + spp_per_pass - 1) // spp_per_pass
    data = None
    for p in range(n_pass):
        args = (scene, integrator_sample, seed, p, spp_per_pass, cfg,
                rfilter)
        if torch.is_grad_enabled():
            d = checkpoint(_render_pass, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            d = _render_pass(*args)
        data = d if data is None else data + d
    block = ImageBlock(data=data, width=width, height=height,
                       n_channels=data.shape[-1] - 1)
    return block.develop()


def _grads(outputs, p0, cotangent=None):
    keys = list(p0)
    if not outputs.requires_grad:  # no parameter reaches the image
        return {k: torch.zeros_like(p) for k, p in p0.items()}
    grads = torch.autograd.grad(outputs, [p0[k] for k in keys], cotangent,
                                allow_unused=True)
    return {k: torch.zeros_like(p0[k]) if g is None else g
            for k, g in zip(keys, grads)}


@fp32_matmul()
def render_loss_grad(scene, integrator_sample, loss_fn: Callable,
                     param_keys, seed: int = 0, spp: int = 4,
                     cfg: RenderConfig = RGB,
                     geometry_boundary: bool = False,
                     boundary_samples: int = 1 << 14, **kw):
    """(loss, {key: gradient}) for the dotted-key parameters `param_keys`;
    loss_fn maps the image [H, W, C] to a scalar tensor. A parameter that
    does not reach the image gets a zero gradient.

    `geometry_boundary=True` adds the silhouette boundary terms
    (`ad/projective.py`: camera silhouettes, point-light shadows and
    area-light penumbrae, `boundary_samples` edge samples each) to the
    `geo.tri_p*` gradients asked for. Without them a vertex row's gradient
    is the interior term alone, which the render's tables make zero (they
    are not rebuilt from the rows), as in the JAX package."""
    params = traverse(scene)
    p0 = {k: params[k].detach().requires_grad_(True) for k in param_keys}
    with torch.enable_grad():
        img = render_differentiable(params.update(p0), integrator_sample,
                                    seed=seed, spp=spp, cfg=cfg, **kw)
        loss = loss_fn(img)
        grads = _grads(loss, p0)
    if geometry_boundary and any(k.startswith("geo.tri_p") for k in grads):
        from .projective import (area_nee_boundary_grad_guided,
                                 nee_boundary_grad, primary_boundary_grad)

        with torch.enable_grad():
            img_d = img.detach().requires_grad_(True)
            (grad_img,) = torch.autograd.grad(loss_fn(img_d), img_d)
        kw_b = dict(n_samples=boundary_samples, cfg=cfg)
        terms = (
            primary_boundary_grad(scene, integrator_sample, grad_img,
                                  key=seed + 0x9E37, **kw_b),
            # shadow silhouettes of point-like emitters (zero without)
            nee_boundary_grad(scene, integrator_sample, grad_img,
                              key=seed + 0x85EB, **kw_b),
            # penumbrae of area emitters (zero without)
            area_nee_boundary_grad_guided(scene, grad_img,
                                          key=seed + 0x27D4, **kw_b))
        for k in grads:
            if k in terms[0]:
                grads[k] = grads[k] + terms[0][k] + terms[1][k] + terms[2][k]
    return loss.detach(), grads


@fp32_matmul()
def render_grad(scene, integrator_sample, param_keys, grad_image,
                seed: int = 0, spp: int = 4, cfg: RenderConfig = RGB, **kw):
    """The adjoint render: the image-space gradient `grad_image` [H, W, C]
    pulled back to the parameters `param_keys` ({key: gradient})."""
    params = traverse(scene)
    p0 = {k: params[k].detach().requires_grad_(True) for k in param_keys}
    with torch.enable_grad():
        img = render_differentiable(params.update(p0), integrator_sample,
                                    seed=seed, spp=spp, cfg=cfg, **kw)
        return _grads(img, p0, grad_image)


def render_forward(scene, integrator_sample,
                   param_tangents: Dict[str, Any], seed: int = 0,
                   spp: int = 4, cfg: RenderConfig = RGB, **kw):
    """Forward mode: (image, d_image), d_image = sum_k dI/d(param_k) .
    tangent_k [H, W, C], by `torch.autograd.forward_ad` dual tensors (one
    render with the tangents alongside, no backward graph). Tangents
    broadcast against their parameters."""
    params = traverse(scene)
    with fwAD.dual_level(), torch.no_grad():
        duals = {}
        for k, t in param_tangents.items():
            p = params[k]
            t = torch.as_tensor(t, dtype=p.dtype, device=p.device)
            duals[k] = fwAD.make_dual(p, t.expand(p.shape).contiguous())
        img = render_differentiable(params.update(duals), integrator_sample,
                                    seed=seed, spp=spp, cfg=cfg, **kw)
        primal, tangent = fwAD.unpack_dual(img)
        if tangent is None:
            tangent = torch.zeros_like(primal)
        return primal.clone(), tangent.clone()
