"""Render-mode configuration. This slice ports the unpolarized RGB mode
(three channels) only; the JAX package's spectral, mono and polarized
variants follow in later slices."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    @property
    def n_channels(self) -> int:
        return 3


RGB = RenderConfig()
