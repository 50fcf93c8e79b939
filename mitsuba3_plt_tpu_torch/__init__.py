"""PyTorch/CUDA port of mitsuba3_plt_tpu for NVIDIA Hopper.

This package renders the PLT (physical light transport) wave-optics path
of the JAX package with PyTorch tensors and hand-written CUDA kernels for
`sm_90a`. Plain tensor code is PyTorch; the kernels live in `ops/`, each
beside a plain PyTorch version of the same function that runs when the
inputs lie on the CPU.

Entry points take `device=` and default to "cuda": with no card and no
explicit `device="cpu"` they raise instead of falling back.

    import mitsuba3_plt_tpu_torch as mi
    scene, meta = mi.load_file("scene.xml", resx=256, resy=256)
    img = mi.render((scene, meta), spp=64)      # [H, W, C] on the card
"""
from . import config  # noqa: F401  (callable: the current variant's config)
from .config import RGB, RGB_POLARIZED, RenderConfig, VARIANTS  # noqa: F401
from .config import current_variant as variant  # noqa: F401
from .config import set_variant  # noqa: F401
from .core.device import resolve_device  # noqa: F401

__version__ = "0.1.0"


def load_file(path, parameters=None, *, device="cuda", **overrides):
    """(Scene on `device`, meta) of a Mitsuba XML file (`scene/loader.py`);
    `parameters` and `overrides` fill its $name references."""
    from .scene.loader import load_file as _load_file

    return _load_file(path, parameters, device=device, **overrides)


def load_dict(d, *, device="cuda"):
    """(Scene on `device`, meta) of a Mitsuba-style scene dict
    (`scene/dict_loader.py`)."""
    from .scene.dict_loader import load_dict as _load_dict

    return _load_dict(d, device=device)


def render(scene, integrator=None, spp=16, seed=0, cfg=None, **kw):
    """[H, W, C] image of `scene` or of a loaded (scene, meta): the meta's
    integrator (`integrators.make_integrator`), filter and sampler, unless
    given. C is 3, or the integrator's own channel count (15 for stokes).
    Keyword arguments go to `integrators.common.render` (spp_per_pass,
    timeout, progress, stats, ...)."""
    from .integrators import make_integrator
    from .integrators.common import render as _render

    if isinstance(scene, tuple):
        scene, meta = scene
        if integrator is None:
            integrator = make_integrator(meta.get("integrator",
                                                  {"type": "path"}))
        if "rfilter" in meta:
            kw.setdefault("rfilter", meta["rfilter"])
        if "sampler" in meta:
            kw.setdefault("sampler_type", meta["sampler"])
    if integrator is None:
        integrator = make_integrator({"type": "path"})
    return _render(scene, integrator, seed=seed, spp=spp,
                   cfg=cfg or config(), **kw)
