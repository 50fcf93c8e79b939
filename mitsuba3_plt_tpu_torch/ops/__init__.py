"""The kernels of the main paths, of the intersection tools and of the
FMA roof probe. Each wrapper runs its CUDA kernel on CUDA tensors (counting
the launch) and its plain PyTorch version on CPU tensors."""
from __future__ import annotations

from . import grating, intersect, mfu


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {
        "intersect_q": intersect.INTERSECT_Q_LAUNCHES,
        "occluded_q": intersect.OCCLUDED_Q_LAUNCHES,
        "intersect_clu2": intersect.INTERSECT_CLU2_LAUNCHES,
        "occluded_clu2": intersect.OCCLUDED_CLU2_LAUNCHES,
        "intersect_bvh": intersect.INTERSECT_BVH_LAUNCHES,
        "occluded_bvh": intersect.OCCLUDED_BVH_LAUNCHES,
        "intersect_classic": intersect.INTERSECT_CLASSIC_LAUNCHES,
        "occluded_classic": intersect.OCCLUDED_CLASSIC_LAUNCHES,
        "intersect_mxu": intersect.INTERSECT_MXU_LAUNCHES,
        "intersect_clu": intersect.INTERSECT_CLU_LAUNCHES,
        "occluded_clu": intersect.OCCLUDED_CLU_LAUNCHES,
        "intersect_q_variant": intersect.INTERSECT_Q_VARIANT_LAUNCHES,
        "occluded_q_variant": intersect.OCCLUDED_Q_VARIANT_LAUNCHES,
        "intersect_q_macc": intersect.INTERSECT_Q_MACC_LAUNCHES,
        "grating_sample": grating.GRATING_SAMPLE_LAUNCHES,
        "grating_lobe_sum": grating.LOBE_SUM_LAUNCHES,
        "fma_roof": mfu.FMA_ROOF_LAUNCHES,
    }


def reset_launch_counts() -> None:
    intersect.INTERSECT_Q_LAUNCHES = 0
    intersect.OCCLUDED_Q_LAUNCHES = 0
    intersect.INTERSECT_CLU2_LAUNCHES = 0
    intersect.OCCLUDED_CLU2_LAUNCHES = 0
    intersect.INTERSECT_BVH_LAUNCHES = 0
    intersect.OCCLUDED_BVH_LAUNCHES = 0
    intersect.INTERSECT_CLASSIC_LAUNCHES = 0
    intersect.OCCLUDED_CLASSIC_LAUNCHES = 0
    intersect.INTERSECT_MXU_LAUNCHES = 0
    intersect.INTERSECT_CLU_LAUNCHES = 0
    intersect.OCCLUDED_CLU_LAUNCHES = 0
    intersect.INTERSECT_Q_VARIANT_LAUNCHES = 0
    intersect.OCCLUDED_Q_VARIANT_LAUNCHES = 0
    intersect.INTERSECT_Q_MACC_LAUNCHES = 0
    grating.GRATING_SAMPLE_LAUNCHES = 0
    grating.LOBE_SUM_LAUNCHES = 0
    mfu.FMA_ROOF_LAUNCHES = 0
