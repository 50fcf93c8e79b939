"""The main path's kernels. Each wrapper runs its CUDA kernel on CUDA
tensors (counting the launch) and its plain PyTorch version on CPU tensors."""
from __future__ import annotations

from . import grating, intersect


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {
        "intersect_q": intersect.INTERSECT_Q_LAUNCHES,
        "occluded_q": intersect.OCCLUDED_Q_LAUNCHES,
        "grating_sample": grating.GRATING_SAMPLE_LAUNCHES,
        "grating_lobe_sum": grating.LOBE_SUM_LAUNCHES,
    }


def reset_launch_counts() -> None:
    intersect.INTERSECT_Q_LAUNCHES = 0
    intersect.OCCLUDED_Q_LAUNCHES = 0
    grating.GRATING_SAMPLE_LAUNCHES = 0
    grating.LOBE_SUM_LAUNCHES = 0
