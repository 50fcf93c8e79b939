"""Render-mode configuration: RGB (three channels), unpolarized or
polarized. Under a polarized config radiance is a Stokes vector and a BSDF
value a Mueller matrix (`librender/mueller.py` gives the layout). The JAX
package's spectral and mono variants are not ported: asking for them by
name raises.

The module is callable: `config()` (the package's `mitsuba3_plt_tpu_torch
.config()`, as in the JAX package) is the config of the variant that
`set_variant` chose, "rgb" by default."""
from __future__ import annotations

import dataclasses
import sys
import types


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    polarized: bool = False

    @property
    def n_channels(self) -> int:
        return 3

    @property
    def name(self) -> str:
        return "rgb_polarized" if self.polarized else "rgb"


RGB = RenderConfig()
RGB_POLARIZED = RenderConfig(polarized=True)

VARIANTS = {"rgb": RGB, "rgb_polarized": RGB_POLARIZED}
# the JAX package's variants that the port does not have
_NOT_PORTED = ("spectral", "spectral_polarized", "mono", "mono_polarized")


def variant(name: str) -> RenderConfig:
    """The config of a variant name, as the JAX package's `VARIANTS` names
    it."""
    if name in VARIANTS:
        return VARIANTS[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"variant {name!r} is not ported")
    raise KeyError(f"unknown variant {name!r}")


_current = "rgb"


def set_variant(name: str):
    """Render under variant `name` by default ("rgb" or "rgb_polarized");
    a variant of the JAX package that is not ported raises."""
    global _current
    variant(name)
    _current = name


def current_variant() -> str:
    return _current


class _CallableModule(types.ModuleType):
    def __call__(self) -> RenderConfig:
        """The config of the current variant."""
        return VARIANTS[_current]


sys.modules[__name__].__class__ = _CallableModule
