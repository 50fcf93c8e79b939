"""The Stokes path's gradients on the glass box (CPU), continued from
`test_torch_ad_polarized.py`: `StokesIntegrator(PolarizedPathIntegrator(3,
9))` on cornell_box(16, 16, box_material="dielectric"), the mean of the
15-channel image, on the base colour and the index against jax.grad of
the JAX package's render with its NaN sources patched and its hit search
detached (`jax_nan_safe`). The index gradient runs through the lobe's
detached pdf (the port's `dielectric_mueller`, as JAX's) and the refracted
directions."""
from test_torch_ad_polarized import jax_nan_safe  # noqa: F401
from test_torch_ad_polarized import stokes_grads_match_jax
from test_torch_golden_specular import one_torch_thread  # noqa: F401


def test_stokes_glass_grads_match_jax(jax_nan_safe):  # noqa: F811
    stokes_grads_match_jax("dielectric")
