"""PyTorch/CUDA port of mitsuba3_plt_tpu for NVIDIA Hopper.

This package renders the PLT (physical light transport) wave-optics path
of the JAX package with PyTorch tensors and hand-written CUDA kernels for
`sm_90a`. Plain tensor code is PyTorch; the four kernels of the main path
(closest hit, any hit, grating sample chain, grating lobe sum) live in
`ops/`, each beside a plain PyTorch version of the same function that runs
when the inputs lie on the CPU.

Entry points take `device=` and default to "cuda": with no card and no
explicit `device="cpu"` they raise instead of falling back.
"""
from .config import RGB, RGB_POLARIZED, RenderConfig, VARIANTS  # noqa: F401
from .core.device import resolve_device  # noqa: F401
