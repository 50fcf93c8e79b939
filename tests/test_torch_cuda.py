"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked `cuda`: without a card these skip. On a machine with one (which has
no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX). This file imports no
JAX."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_intersect_kernels_match_plain(card):
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    scene = grating_scene(64, 48, device=card)
    g = scene.geo
    ray, _ = sample_rays(scene, Sampler.create(0, 64 * 48 * 2, device=card),
                         64, 48, 2)
    args = (g.tri_q, g.tri_anchor, ray.o, ray.d, ray.maxt, g.n_faces)
    got, want = isect.intersect_q(*args), isect.intersect_q_plain(*args)
    torch.cuda.synchronize()
    assert (got[1] == want[1]).float().mean() >= 1 - 1e-3
    same = (got[1] == want[1]) & (want[1] >= 0)
    for a, b in zip(got[::2], want[::2]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)
    n = 8192
    o = torch.as_tensor(rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                        device=card)
    d = torch.as_tensor(_dirs(rng, n) * -1.0, device=card)
    mt = torch.as_tensor(rng.uniform(0, 5, n).astype(np.float32), device=card)
    sargs = (g.tri_q, g.tri_anchor, o, d, mt, g.n_faces)
    occ, occ_plain = isect.occluded_q(*sargs), isect.occluded_q_plain(*sargs)
    assert (occ == occ_plain).float().mean() >= 1 - 1e-3


def test_grating_kernels_match_plain(card):
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    rng = np.random.default_rng(2)
    n, f32 = 16384, np.float32
    common = dict(
        grating_dir=np.tile([[1.0, 0.0]], (n, 1)).astype(f32),
        inv_period=np.tile([[0.6, 0.0]], (n, 1)).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7], n).astype(np.int32),
        gtype=np.zeros(n, np.int32), multiplier=np.full(n, 10.0, f32),
    )
    t = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    lobe_in = {k: t(v) for k, v in dict(
        common, wi=_dirs(rng, n), wo=_dirs(rng, n),
        wl_nm=rng.uniform(380, 680, (n, 3)).astype(f32),
        coherence=rng.uniform(1, 120, n).astype(f32),
        a_cone=rng.uniform(0.05, 0.4, n).astype(f32)).items()}
    got = gops.grating_lobe_sum(**lobe_in, half=3, separable=True,
                                n_channels=3)
    want = gops.grating_lobe_sum_plain(**lobe_in, half=3, separable=True)
    ok = torch.isclose(got, want, rtol=2e-3, atol=2e-5).all(-1)
    assert ok.float().mean() >= 1 - 1e-3

    for ndf in (0, 1):
        s_in = {k: t(v) for k, v in dict(
            common, wi=_dirs(rng, n),
            u2=rng.uniform(0, 1, (n, 2)).astype(f32),
            lobe_u2=rng.uniform(0, 1, (n, 2)).astype(f32),
            wl_um=rng.uniform(0.38, 0.68, n).astype(f32),
            alpha=rng.uniform(0.03, 0.3, (n, 2)).astype(f32)).items()}
        got = gops.grating_sample(**s_in, half=3, ndf=ndf)
        want = gops.grating_sample_plain(**s_in, half=3, ndf=ndf)
        same = (got["lobe"] == want["lobe"]).all(-1) & (got["ok"] == want["ok"])
        assert same.float().mean() >= 1 - 1e-3
        live = same & want["ok"]
        close = torch.isclose(got["wo"][live], want["wo"][live],
                              rtol=1e-4, atol=1e-5).all(-1)
        assert close.float().mean() >= 1 - 1e-3


def test_render_launches_each_kernel_once_per_bounce(card):
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    scene = grating_scene(32, 24, device=card)
    ops.reset_launch_counts()
    img = render(scene, PLTIntegrator(max_depth=4, rr_depth=2), spp=4,
                 spp_per_pass=2)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert ops.launch_counts() == {"intersect_q": 8, "occluded_q": 8,
                                   "grating_sample": 8, "grating_lobe_sum": 8}
