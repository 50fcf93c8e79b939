"""CIE 1931 colour matching and XYZ -> linear sRGB (Rec. 709, D65).

The table is the standard public CIE data on the 5 nm grid 360..830 nm
(95 samples), stored beside this module.
"""
from __future__ import annotations

import os

import numpy as np
import torch

CIE_MIN = 360.0
CIE_MAX = 830.0
CIE_SAMPLES = 95

_data = np.load(os.path.join(os.path.dirname(__file__), "data_cie1931.npz"))
CIE_XYZ_TABLE = np.asarray(_data["xyz"], np.float32)  # [3, 95]

XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    np.float32,
)


def cie1931_xyz(wavelengths: torch.Tensor) -> torch.Tensor:
    """CIE XYZ colour matching values at `wavelengths` [nm] -> [..., 3],
    linearly interpolated on the CIE grid, 0 outside [CIE_MIN, CIE_MAX]."""
    table = torch.as_tensor(CIE_XYZ_TABLE.T, device=wavelengths.device)
    t = (wavelengths - CIE_MIN) / (CIE_MAX - CIE_MIN) * (CIE_SAMPLES - 1)
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, CIE_SAMPLES - 2)
    f = (t - i.to(torch.float32))[..., None]
    xyz = table[i] * (1.0 - f) + table[i + 1] * f
    inside = (wavelengths >= CIE_MIN) & (wavelengths <= CIE_MAX)
    return torch.where(inside[..., None], xyz, 0.0)


def xyz_to_srgb(xyz: torch.Tensor) -> torch.Tensor:
    M = torch.as_tensor(XYZ_TO_SRGB, device=xyz.device)
    return xyz @ M.T
