"""Explicit device selection: no probing, no silent CPU fallback; and
full float32 matrix products for the renders."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, raising when CUDA is asked for
    and no card is present (the CPU is used only when asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Matrix products in full float32 for the duration: torch's two TF32
    flags (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`) off, and restored as the caller
    had them on exit, exceptions included. The renders run inside it: the
    camera's ray products, B9's plain product and the table-row gradient
    (`core/math.py::rows_sum_one_hot`) would otherwise round to TF32
    wherever a caller has switched TF32 on."""
    cuda_mm = torch.backends.cuda.matmul
    saved = (cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda_mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
