"""The plain versions of the grating kernels against the JAX package: the
lobe sum against its XLA chain and its Pallas kernel (interpret mode), the
sample chain against its Pallas kernel, on the cases and tolerances of
tests/test_grating_pallas.py; and the lobe-sum kernel's Bessel table
against the sweep it tabulates."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba3_plt_tpu.plt.grating as jgr
from mitsuba3_plt_tpu.ops.grating_pallas import (
    _lobe_sum_xla, grating_lobe_sum as j_lobe_sum, grating_sample as j_sample,
)
from mitsuba3_plt_tpu_torch.ops import grating as tg

LOBE_CASES = [
    (3, True, jgr.SINUSOIDAL, 0.0),
    (3, False, jgr.SINUSOIDAL, 1.5),
    (4, True, jgr.RECTANGULAR, 0.0),
    (2, True, jgr.LINEAR, 0.0),
]


def _rand_dir(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _lobe_inputs(gtype, ip_y, seed=7):
    rng = np.random.default_rng(seed)
    N, C = 2048, 3
    f32 = np.float32
    return dict(
        wi=_rand_dir(rng, N), wo=_rand_dir(rng, N),
        wl_nm=rng.uniform(380, 680, (N, C)).astype(f32),
        grating_dir=np.stack([np.ones(N), np.zeros(N)], -1).astype(f32),
        inv_period=np.stack([np.full(N, 2.0), np.full(N, ip_y)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, N).astype(f32),
        lobes=rng.choice([3, 5, 7, 9], N).astype(np.int32),
        gtype=np.full(N, gtype, np.int32),
        multiplier=np.full(N, 1.3, f32),
        coherence=rng.uniform(1.0, 120.0, N).astype(f32),
        a_cone=rng.uniform(0.05, 0.4, N).astype(f32),
    )


def _torch(ins):
    return {k: torch.as_tensor(v) for k, v in ins.items()}


@pytest.mark.parametrize("half,separable,gtype,ip_y", LOBE_CASES)
def test_lobe_sum_plain_matches_xla_chain(half, separable, gtype, ip_y):
    ins = _lobe_inputs(gtype, ip_y)
    j = {k: jnp.asarray(v) for k, v in ins.items()}
    want = _lobe_sum_xla(
        j["wi"], j["wo"], j["wl_nm"], j["grating_dir"], j["inv_period"],
        j["q"], j["lobes"].astype(jnp.float32),
        j["gtype"].astype(jnp.float32), j["multiplier"], j["coherence"],
        j["a_cone"], half=half, separable=separable)
    got = tg.grating_lobe_sum(**_torch(ins), half=half, separable=separable,
                              n_channels=3)
    assert got.dtype == torch.float32 and got.shape == (2048, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("half,separable,gtype,ip_y", LOBE_CASES)
def test_lobe_sum_plain_matches_pallas_interpret(half, separable, gtype, ip_y):
    ins = _lobe_inputs(gtype, ip_y, seed=8)
    j = {k: jnp.asarray(v) for k, v in ins.items()}
    want = j_lobe_sum(**j, half=half, separable=separable, n_channels=3,
                      interpret=True)
    got = tg.grating_lobe_sum(**_torch(ins), half=half, separable=separable,
                              n_channels=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-5)


def _sample_inputs(gtype, ip_y, seed):
    rng = np.random.default_rng(seed)
    N = 2048
    f32 = np.float32
    return dict(
        wi=_rand_dir(rng, N),
        u2=rng.uniform(0, 1, (N, 2)).astype(f32),
        lobe_u2=rng.uniform(0, 1, (N, 2)).astype(f32),
        wl_um=rng.uniform(0.38, 0.68, N).astype(f32),
        alpha=rng.uniform(0.03, 0.3, (N, 2)).astype(f32),
        grating_dir=np.stack([np.ones(N), np.zeros(N)], -1).astype(f32),
        inv_period=np.stack([np.full(N, 2.0), np.full(N, ip_y)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, N).astype(f32),
        lobes=rng.choice([3, 5, 7], N).astype(np.int32),
        gtype=np.full(N, gtype, np.int32),
        multiplier=np.full(N, 1.1, f32),
    )


@pytest.mark.parametrize("ndf", [0, 1])
@pytest.mark.parametrize("gtype,ip_y", [(jgr.SINUSOIDAL, 0.0),
                                        (jgr.RECTANGULAR, 1.5)])
def test_sample_plain_matches_pallas_interpret(ndf, gtype, ip_y):
    ins = _sample_inputs(gtype, ip_y, seed=11 + ndf)
    want = {k: np.asarray(v) for k, v in j_sample(
        **{k: jnp.asarray(v) for k, v in ins.items()}, half=3, ndf=ndf,
        interpret=True).items()}
    got = {k: v.numpy() for k, v in tg.grating_sample(
        **_torch(ins), half=3, ndf=ndf).items()}
    assert got["lobe"].dtype == np.int32 and got["ok"].dtype == bool
    np.testing.assert_array_equal(got["lobe"], want["lobe"])
    np.testing.assert_array_equal(got["ok"], want["ok"])
    ok = want["ok"]
    # Beckmann: the Pallas kernel's polynomial erf (|err| <= 1.5e-7) against
    # the exact erf moves the Newton inversion's normal by up to ~1e-4
    dir_atol = 1e-4 if ndf == 1 else 1e-5
    np.testing.assert_allclose(got["mvec"], want["mvec"], rtol=1e-4,
                               atol=dir_atol)
    np.testing.assert_allclose(got["reflection_dir"], want["reflection_dir"],
                               rtol=1e-4, atol=dir_atol)
    np.testing.assert_allclose(got["wo"][ok], want["wo"][ok],
                               rtol=1e-4, atol=dir_atol)
    # near-specular lanes can saturate to inf in one version only (1/cos^4
    # at float eps differences); pdfs that large are MIS-equivalent: clip
    np.testing.assert_allclose(np.minimum(got["pdf"][ok], 1e6),
                               np.minimum(want["pdf"][ok], 1e6),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got["w_g1_int"][ok], want["w_g1_int"][ok],
                               rtol=2e-3, atol=1e-6)


def test_wrappers_check_arguments():
    ins = _torch(_sample_inputs(jgr.SINUSOIDAL, 0.0, seed=3))
    with pytest.raises(TypeError):
        tg.grating_sample(**{**ins, "lobes": ins["lobes"].float()}, half=3)
    with pytest.raises(ValueError):
        tg.grating_sample(**{**ins, "wi": ins["wi"][:10]}, half=3)
    with pytest.raises(ValueError):
        tg.grating_sample(**{**ins, "alpha": ins["alpha"].t().contiguous().t()},
                          half=3)
    with pytest.raises(ValueError):
        tg.grating_sample(**ins, half=5)
    lins = _torch(_lobe_inputs(jgr.SINUSOIDAL, 0.0))
    with pytest.raises(ValueError):
        tg.grating_lobe_sum(**lins, half=3, separable=True, n_channels=4)


def test_bessel_table_at_grid_points_is_the_float64_sweep():
    """At t = 0 the kernel's three fmaf leave c0: the float64 sweep at the
    grid point rounded to float32, J_0 = 1 and J_nu = 0 at x = 0."""
    table = tg.bessel_table("cpu")
    assert table.shape == (tg.MAX_HALF + 1, tg.BESSEL_TABLE_N, 4)
    assert table.dtype == torch.float32 and tg.bessel_table("cpu") is table
    x = torch.arange(tg.BESSEL_TABLE_N, dtype=torch.float64) \
        * tg.BESSEL_TABLE_STEP
    want = torch.stack(tg.bessel_sweep(x, tg.MAX_HALF)).float()
    got = torch.stack(tg.bessel_table_lookup(table, x.float(), tg.MAX_HALF))
    assert torch.equal(got, want)
    assert got[0, 0] == 1.0 and (got[1:, 0] == 0.0).all()


def test_bessel_table_matches_float32_sweep():
    """On a dense grid over [0, 48] (8 points an interval) the table read as
    the kernel reads it stays within 1e-6 of the float32 sweep, the plain
    version's own Bessel values (measured 3.2e-7: the float32 sweep's
    rounding, which the float64 table does not carry)."""
    table = tg.bessel_table("cpu")
    x = torch.arange(tg.BESSEL_TABLE_N * 8 + 1, dtype=torch.float32) \
        * (tg.BESSEL_TABLE_STEP / 8)
    assert float(x[-1]) == tg.ASYMP_SWITCH
    for half in range(tg.MAX_HALF + 1):
        got = tg.bessel_table_lookup(table, x, half)
        want = tg.bessel_sweep(x, half)
        assert len(got) == half + 1
        for g_nu, w_nu in zip(got, want):
            assert (g_nu - w_nu).abs().max() <= 1e-6


def test_bessel_table_interpolation_at_midpoints():
    """At the interval midpoints, farthest from the grid: the cubic Hermite
    interpolant in float64 is within 5e-9 of the float64 sweep (measured
    9.3e-10, the grid step 1/32), and the float32 table read as the kernel
    reads it within 2e-7 (float32 rounding of the coefficients and of the
    three fmaf; measured 5.1e-8)."""
    h = tg.BESSEL_TABLE_STEP
    xm = (torch.arange(tg.BESSEL_TABLE_N, dtype=torch.float64) + 0.5) * h
    want = torch.stack(tg.bessel_sweep(xm, tg.MAX_HALF))
    c = tg.bessel_table_coefficients()
    herm = c[..., 0] + 0.5 * (c[..., 1] + 0.5 * (c[..., 2] + 0.5 * c[..., 3]))
    assert (herm - want).abs().max() <= 5e-9
    got = torch.stack(tg.bessel_table_lookup(tg.bessel_table("cpu"),
                                             xm.float(), tg.MAX_HALF))
    assert (got.double() - want).abs().max() <= 2e-7
