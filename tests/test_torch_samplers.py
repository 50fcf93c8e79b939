"""The port's pixel samplers against the JAX package's: the CMJ, Halton,
scrambled (0,2)-sequence and orthogonal-array points bit for bit on seeded
sample indices and patterns, the CMJ permutation's fixed-trip walk on
domains that need walks, and the camera wavefront of every sampler type
(`camera_rays_at`, also in Morton order and on the regenerative path)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core import rng as jrng
from mitsuba3_plt_tpu.integrators.common import camera_rays_at as j_cam
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.core import rng as trng
from mitsuba3_plt_tpu_torch.integrators.common import (camera_rays_at,
                                                       render)
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_golden_specular import one_torch_thread  # noqa: F401

N = 1 << 14
SPPS = (1, 2, 3, 4, 7, 8, 12, 16, 33, 64)


def _u32(rng, n):
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 0xFFFFFFFF]
    return x


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("spp", SPPS)
def test_cmj_and_orthogonal_bit_identical(spp):
    rng = np.random.default_rng(spp)
    s = rng.integers(0, spp, N).astype(np.uint32)
    pat = _u32(rng, N)
    for name in ("cmj_sample_2d", "orthogonal_2d"):
        want = np.asarray(getattr(jrng, name)(jnp.asarray(s), spp,
                                              jnp.asarray(pat)))
        got = getattr(trng, name)(_t(s), spp, _t(pat)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


@pytest.mark.parametrize("l", [1, 3, 5, 12, 17, 33, 100, 129])
def test_cmj_permute_walks_to_the_same_bijection(l):
    """Domains that are not powers of two need the cycle walk: the masked
    fixed-trip loop lands where JAX's while loop does, and each pattern's
    map is a bijection of [0, l) (but where i + p wraps past 2^32, as in
    JAX's u32 sum)."""
    rng = np.random.default_rng(l)
    pats = _u32(rng, 64)
    i = np.tile(np.arange(l, dtype=np.uint32), len(pats))
    p = np.repeat(pats, l)
    want = np.asarray(jrng._cmj_permute(jnp.asarray(i), l, jnp.asarray(p)))
    got = trng._cmj_permute(_t(i), l, _t(p)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for pat, row in zip(pats, got.reshape(len(pats), l)):
        if int(pat) + l < 2**32:
            assert sorted(row) == list(range(l))


def test_halton_and_ld_bit_identical():
    """The base-2 and base-3 radical inverses, the Sobol' dimension and the
    two rotated / scrambled points, on sample indices over the whole u32
    range. The base-3 sum (20 digits of products and sums rounded one by
    one) reaches the bit too: XLA's CPU build does not contract it."""
    rng = np.random.default_rng(1)
    s = _u32(rng, N)
    s[3:1000] = np.arange(997)
    pat = _u32(rng, N)
    js, jp = jnp.asarray(s), jnp.asarray(pat)
    ts, tp = _t(s), _t(pat)
    pairs = [
        (jrng._bit_reverse32(js), trng._bit_reverse32(ts)),
        (jrng._radical_inverse_base2(js), trng._radical_inverse_base2(ts)),
        (jrng._radical_inverse_base3(js), trng._radical_inverse_base3(ts)),
        (jrng._sobol2(js, jp), trng._sobol2(ts, tp)),
        (jrng.halton_2d(js, jp), trng.halton_2d(ts, tp)),
        (jrng.ld_2d(js, jp), trng.ld_2d(ts, tp)),
        (jrng._cmj_randfloat(js, jp), trng._cmj_randfloat(ts, tp)),
    ]
    for k, (want, got) in enumerate(pairs):
        want = np.asarray(want)
        got = got.numpy()
        if want.dtype == np.uint32:
            got = got.astype(np.uint32)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=str(k))


SAMPLER_TYPES = ("independent", "stratified", "multijitter", "ldsampler",
                 "halton", "orthogonal")


@pytest.mark.parametrize("sampler_type", SAMPLER_TYPES)
@pytest.mark.parametrize("spp", [1, 9])
def test_camera_rays_at_match_jax(sampler_type, spp):
    """uv to the bit, o and d at 1e-6 (the camera's product and
    normalisation), on scanline lanes and on a shuffled subset of sample
    ids, as the regenerative wavefront asks for them."""
    W, H = 16, 16
    jscene, _ = jpresets.cornell_box(W, H)
    tscene = tpresets.cornell_box(W, H, device="cpu")
    n = W * H * spp
    rng = np.random.default_rng(spp)
    for lanes in (np.arange(n, dtype=np.uint32),
                  rng.permutation(n)[: n // 2].astype(np.uint32)):
        for order in ("scanline", "morton"):
            jray, juv, _, _ = j_cam(jscene, 11, jnp.asarray(lanes), W, H,
                                    spp, JRGB, sampler_type=sampler_type,
                                    pixel_order=order)
            tray, tuv = camera_rays_at(tscene, 11, _t(lanes), W, H, spp,
                                       order, sampler_type)
            np.testing.assert_array_equal(_bits(tuv.numpy()), _bits(juv))
            np.testing.assert_allclose(tray.o.numpy(), np.asarray(jray.o),
                                       atol=1e-6)
            np.testing.assert_allclose(tray.d.numpy(), np.asarray(jray.d),
                                       atol=1e-6)


def test_unknown_sampler_type_raises():
    scene = tpresets.cornell_box(4, 4, device="cpu")
    with pytest.raises(ValueError, match="sampler_type"):
        camera_rays_at(scene, 0, torch.arange(16), 4, 4, 1,
                       sampler_type="sobol")
    with pytest.raises(ValueError, match="sampler_type"):
        render(scene, PathIntegrator(2, 9), spp=2, sampler_type="pmj")


def test_regen_takes_the_sampler_type():
    """The regenerative wavefront draws each sample's camera ray with the
    pass's sampler type, and splats through the pass's filter at the
    camera wavefront's film positions: its image equals the fixed-depth
    render's."""
    scene = tpresets.cornell_box(128, 128, device="cpu")
    integ = PathIntegrator(max_depth=2, rr_depth=9)
    kw = dict(seed=3, spp=4, sampler_type="multijitter", rfilter="gaussian")
    stats = {}
    a = render(scene, integ, regen=True, stats=stats, **kw)
    b = render(scene, integ, **kw)
    assert stats["regen_iterations"]
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)
    c = render(scene, integ, seed=3, spp=4)
    assert not torch.equal(b, c)
