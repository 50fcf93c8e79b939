"""Render-mode configuration: RGB (three channels), unpolarized or
polarized. Under a polarized config radiance is a Stokes vector and a BSDF
value a Mueller matrix (`librender/mueller.py` gives the layout). The JAX
package's spectral and mono variants are not ported: asking for them by
name raises."""
from __future__ import annotations

import dataclasses


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
