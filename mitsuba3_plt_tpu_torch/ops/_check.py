"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def check_tensors(name, specs, n=None):
    """specs: {arg: (tensor, dtype, trailing shape)}. All tensors must share
    one device, be contiguous, have the dtype and shape [N, *trailing].
    Returns (device, N)."""
    dev = None
    for arg, (t, dtype, trailing) in specs.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if trailing is None:
            continue
        if n is None:
            n = t.shape[0] if t.dim() else None
        if tuple(t.shape) != (n, *trailing):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(t.shape)}, "
                f"expected {(n, *trailing)}"
            )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev, n
