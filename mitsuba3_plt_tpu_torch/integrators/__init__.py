"""Integrators by name, with the JAX package's defaults
(`integrators/__init__.py::make_integrator`): path / mispath, plt, stokes /
stokes_fw (over a nested path tracer) and prb / prb_basic / prb_projective.
The JAX package's other integrators are not ported and raise; a type in no
table (an unresolved $name, say) warns and takes the path tracer."""
from __future__ import annotations

import warnings

PORTED = ("path", "mispath", "plt", "stokes", "stokes_fw", "prb",
          "prb_basic", "prb_projective")
UNPORTED = ("direct", "direct_projective", "depth", "aov", "moment",
            "volpath", "volpathmis", "prbvolpath", "ptracer")


def _int(cfg, key, default):
    try:
        return int(cfg.get(key, default))
    except (TypeError, ValueError):  # an unresolved "$param"
        return default


def _depths(cfg):
    depth = _int(cfg, "max_depth", 6)
    if depth < 0:
        raise ValueError(f"max_depth {depth}: unbounded depth is not ported")
    return depth, _int(cfg, "rr_depth", 5)


def make_integrator(cfg: dict):
    """The integrator of a config dict ({"type": ..., "max_depth": ...,
    "rr_depth": ..., "nested": {...}}), as a loaded scene's meta holds
    it."""
    t = cfg.get("type", "path")
    if t in UNPORTED:
        raise NotImplementedError(f"integrator {t!r} is not ported: "
                                  "ROADMAP A10")
    if t in ("prb", "prb_basic", "prb_projective"):
        # prb_projective's primal is prb's; its boundary terms live in the
        # gradient layer (`ad.render_loss_grad(..., geometry_boundary=True)`)
        from .prb import PRBIntegrator

        return PRBIntegrator(*_depths(cfg))
    if t == "plt":
        from .plt import PLTIntegrator

        return PLTIntegrator(*_depths(cfg))
    if t in ("stokes", "stokes_fw"):
        from .stokes import PolarizedPathIntegrator, StokesIntegrator

        nested = cfg.get("nested")
        inner = None
        if nested is not None and nested.get("type", "path") in (
                "path", "mispath"):
            inner = PolarizedPathIntegrator(*_depths(nested))
        elif nested is not None:
            raise NotImplementedError(
                f"stokes over {nested.get('type')!r} is not ported")
        return StokesIntegrator(inner=inner, forward_basis=(t == "stokes_fw"))
    if t not in ("path", "mispath"):
        warnings.warn(f"integrator type {t!r} unavailable; using 'path'")
    from .path import PathIntegrator

    return PathIntegrator(*_depths(cfg))
