"""BSDF flags, type tags and the struct-of-tensors material table.

A wavefront is evaluated by running every present BSDF type on all lanes
and selecting per lane by the material's type tag (masked dispatch)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


class BSDFFlags:
    Empty = 0
    Null = 0x00001
    DiffuseReflection = 0x00002
    DiffuseTransmission = 0x00004
    GlossyReflection = 0x00008
    GlossyTransmission = 0x00010
    DeltaReflection = 0x00020
    DeltaTransmission = 0x00040
    FrontSide = 0x08000
    BackSide = 0x10000

    Diffuse = DiffuseReflection | DiffuseTransmission
    Glossy = GlossyReflection | GlossyTransmission
    Smooth = Diffuse | Glossy
    Delta = DeltaReflection | DeltaTransmission | Null


# type tags: the JAX package's values, so its tables carry over unchanged
BSDF_DIFFUSE = 1
BSDF_ROUGH_CONDUCTOR = 3
BSDF_ROUGH_GRATING = 9

# microfacet NDF tags
GGX = 0
BECKMANN = 1

# rough materials whose NDF enters the scene-wide consensus; the JAX tags of
# roughdielectric (6), roughplastic (8) and pplastic (13) are listed so a
# bridged table is judged exactly as the JAX package judges it
_ROUGH_TYPES = (BSDF_ROUGH_CONDUCTOR, 6, 8, 13, BSDF_ROUGH_GRATING)

# per-lane fields of the table, with their dtypes
FIELDS = {
    "mtype": torch.int64, "flags": torch.int64, "twosided": torch.bool,
    "base_color": torch.float32, "eta_re": torch.float32,
    "eta_im": torch.float32, "alpha": torch.float32,
    "grt_inv_period": torch.float32, "grt_height": torch.float32,
    "grt_lobes": torch.int32, "grt_type": torch.int32,
    "grt_multiplier": torch.float32, "grt_coherence": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """[M, ...] per field; the trailing fields are static metadata."""

    mtype: torch.Tensor           # [M] type tag
    flags: torch.Tensor           # [M] BSDFFlags
    twosided: torch.Tensor        # [M] bool
    base_color: torch.Tensor      # [M, 3]
    eta_re: torch.Tensor          # [M, 3] conductor eta
    eta_im: torch.Tensor          # [M, 3] conductor k
    alpha: torch.Tensor           # [M, 2] roughness (u, v)
    grt_inv_period: torch.Tensor  # [M, 2] 1/um
    grt_height: torch.Tensor      # [M] um
    grt_lobes: torch.Tensor       # [M] int32
    grt_type: torch.Tensor        # [M] int32
    grt_multiplier: torch.Tensor  # [M]
    grt_coherence: torch.Tensor   # [M]
    present_types: Tuple[int, ...] = ()
    # (max_half, separable): max_half bounds the lobe grid; separable means
    # every grating is 1D, axis-aligned and not radial
    grt_static: Tuple[int, int] = (0, 0)
    # scene-wide microfacet NDF of the rough materials
    mf_static: int = BECKMANN

    def gather(self, midx) -> Dict[str, torch.Tensor]:
        """Per-lane parameters for material indices midx [N]."""
        return {name: getattr(self, name)[midx] for name in FIELDS}


def finalize_grating_meta(mtype, mf_type, grt_lobes, grt_inv_period,
                          grt_type) -> Tuple[Tuple[int, int], int]:
    """Host-side static metadata from numpy material arrays:
    ((max_half, separable), mf_static). A scene that mixes NDFs uses the
    majority NDF for every rough material, as the JAX package does."""
    mtype = np.asarray(mtype)
    rough = np.isin(mtype, _ROUGH_TYPES)
    if rough.any():
        vals, counts = np.unique(np.asarray(mf_type)[rough],
                                 return_counts=True)
        mf_static = int(vals[np.argmax(counts)])
    else:
        mf_static = BECKMANN
    grating = mtype == BSDF_ROUGH_GRATING
    if not grating.any():
        return (0, 0), mf_static
    lobes = np.asarray(grt_lobes)[grating]
    inv_p = np.asarray(grt_inv_period)[grating]
    gtype = np.asarray(grt_type)[grating]
    max_half = int(min(max(lobes) // 2, 4))
    radial = (gtype & 0x10) != 0
    separable = bool((~radial).all() and (inv_p[:, 1] < 1e-9).all())
    return (max_half, int(separable)), mf_static
