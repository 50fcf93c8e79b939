"""Golden z-tests of the Cornell box's specular and grating boxes, of the
Cornell box through the Gaussian filter and of the analytic scene (sphere
light, disk, cylinder) through the thinlens camera and the multijitter
sampler, for the port, in the scheme of tests/test_golden.py: references
rendered by the JAX package on the CPU (mean and variance over 4 seeds of
16 spp each, in tests/golden_torch/), and the port's own render held to
each by a per-pixel z-test at the Sidak-corrected 1% level. chip_smoke.py
runs the same z-tests on the card, where there is no JAX.

Regenerate the references after an intended change of the JAX package
with (all of them, or the names given):
    JAX_PLATFORMS=cpu python tests/test_torch_golden_specular.py [NAME ...]
"""
import os

import numpy as np
import pytest
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_torch")
SEEDS, SPP = 4, 16

# name: (box_material, integrator, max_depth, rr_depth), 32 x 32
CONFIGS = {
    "cbox_conductor_path": ("conductor", "path", 4, 9),
    "cbox_roughconductor_path": ("roughconductor", "path", 4, 9),
    "cbox_dielectric_path": ("dielectric", "path", 4, 9),
    "cbox_grating_plt": ("grating", "plt", 4, 9),
}
# the camera and film references: name: (scene, render keywords), 32 x 32,
# the path tracer at depth 4 / rr 9
CAMERA_CONFIGS = {
    "cbox_gaussian_path": ("cbox", {"rfilter": "gaussian"}),
    "analytic_path": ("analytic", {"sampler_type": "multijitter"}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for the module: the suite's xdist
    workers share the machine's cores, and torch's default of a thread a
    core oversubscribes them (on the suite's six workers these z-tests
    took 436 s, 16 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ztest_failures(imgs, ref):
    """(failing pixels, max z, threshold) of SEEDS images [S, H, W, C]
    against a reference's mean and var at the Sidak-corrected 1% level."""
    from scipy.stats import norm

    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    z = np.abs(mean - ref["mean"]) / np.sqrt((var + ref["var"]) / SEEDS
                                             + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    thresh = norm.isf(alpha / 2)
    return int((z > thresh).sum()), float(z.max()), thresh


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_render_matches_jax_reference_ztest(name):
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    box, kind, md, rr = CONFIGS[name]
    scene = cornell_box(32, 32, box_material=box, device="cpu")
    integ = (PathIntegrator if kind == "path" else PLTIntegrator)(
        max_depth=md, rr_depth=rr)
    ops.reset_launch_counts()
    imgs = np.stack([render(scene, integ, seed=s, spp=SPP).numpy()
                     for s in range(SEEDS)])
    assert not any(ops.launch_counts().values())  # plain on the CPU
    assert imgs.shape == (SEEDS, 32, 32, 3) and np.isfinite(imgs).all()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    n_fail, z_max, thresh = ztest_failures(imgs, ref)
    assert n_fail == 0, (name, n_fail, z_max, thresh)
    assert imgs.mean() > 0


def port_camera_scene(name, device):
    """The port's scene of CAMERA_CONFIGS[name] at 32 x 32."""
    from mitsuba3_plt_tpu_torch.scene import presets

    if CAMERA_CONFIGS[name][0] == "cbox":
        return presets.cornell_box(32, 32, device=device)
    return presets.analytic_scene(32, 32, device=device)[0]


@pytest.mark.parametrize("name", list(CAMERA_CONFIGS))
def test_camera_and_film_render_matches_jax_reference_ztest(name):
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator

    scene = port_camera_scene(name, "cpu")
    imgs = np.stack([render(scene, PathIntegrator(4, 9), seed=s, spp=SPP,
                            **CAMERA_CONFIGS[name][1]).numpy()
                     for s in range(SEEDS)])
    assert imgs.shape == (SEEDS, 32, 32, 3) and np.isfinite(imgs).all()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    n_fail, z_max, thresh = ztest_failures(imgs, ref)
    assert n_fail == 0, (name, n_fail, z_max, thresh)
    assert imgs.mean() > 0


def _jax_camera_reference(name):
    """(mean, var) of the JAX package's SEEDS renders of CAMERA_CONFIGS
    [name]."""
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.common import render
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.librender.film import FILTER_NAMES
    from mitsuba3_plt_tpu.scene.presets import cornell_box
    from test_torch_analytic import jax_analytic_scene

    kind, kw = CAMERA_CONFIGS[name]
    kw = dict(kw)
    if "rfilter" in kw:
        kw["rfilter"] = FILTER_NAMES[kw["rfilter"]]
    scene = (cornell_box(32, 32)[0] if kind == "cbox"
             else jax_analytic_scene(32, 32)[0])
    integ = PathIntegrator(max_depth=4, rr_depth=9)
    imgs = np.stack([np.asarray(render(scene, integ.sample, seed=s, spp=SPP,
                                       cfg=RGB, n_out_channels=3, **kw))
                     for s in range(SEEDS)])
    return imgs.mean(0), imgs.var(0, ddof=1)


def _jax_reference(name):
    """(mean, var) of the JAX package's SEEDS renders of config `name`."""
    from mitsuba3_plt_tpu.config import RGB
    from mitsuba3_plt_tpu.integrators.common import render
    from mitsuba3_plt_tpu.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu.scene.presets import cornell_box

    box, kind, md, rr = CONFIGS[name]
    scene = cornell_box(32, 32, box_material=box)[0]
    integ = (PathIntegrator if kind == "path" else PLTIntegrator)(
        max_depth=md, rr_depth=rr)
    imgs = np.stack([np.asarray(render(scene, integ.sample, seed=s, spp=SPP,
                                       cfg=RGB, n_out_channels=3))
                     for s in range(SEEDS)])
    return imgs.mean(0), imgs.var(0, ddof=1)


if __name__ == "__main__":
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    names = sys.argv[1:] or [*CONFIGS, *CAMERA_CONFIGS]
    for name in names:
        mean, var = (_jax_camera_reference(name) if name in CAMERA_CONFIGS
                     else _jax_reference(name))
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"{name}.npz"),
                            mean=mean, var=var)
        print(f"wrote {name}: mean {mean.mean():.4f}")
