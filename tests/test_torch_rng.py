"""The port's counter RNG against the JAX package's: bit-identical u32 hashes
and float uniforms, so both draw the same sample stream lane by lane."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.core import rng as jrng
from mitsuba3_plt_tpu_torch.core import rng as trng

N_LANES = 1 << 20


def _bits(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.float32 \
        else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF])
def test_uniform_bit_identical(seed):
    lanes = np.arange(N_LANES, dtype=np.uint32)
    tl = torch.as_tensor(lanes.astype(np.int64))
    for dim in range(4):
        want = np.asarray(jrng.uniform(seed, jnp.asarray(lanes), dim))
        got = trng.uniform(seed, tl, dim).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,salt", [(0, 0), (3, 1), (123456789, 41)])
def test_sampler_next_2d_and_fork_bit_identical(seed, salt):
    js = jrng.Sampler.create(seed, N_LANES).fork(salt)
    ts = trng.Sampler.create(seed, N_LANES, device="cpu").fork(salt)
    for dim in (0, 2):
        want = np.asarray(js.next_2d(dim))
        got = ts.next_2d(dim).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(ts.next_1d(jrng.bounce_dim(2, 6)).numpy()),
        _bits(np.asarray(js.next_1d(jrng.bounce_dim(2, 6)))))
    assert trng.bounce_dim(5, 9) == jrng.bounce_dim(5, 9)


def test_hash_combine_bit_identical():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    # include the u32 edge values
    a[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    b[:4] = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0x7FFFFFFF]
    want = np.asarray(jrng.hash_combine(jnp.asarray(a), jnp.asarray(b)))
    got = trng.hash_combine(torch.as_tensor(a.astype(np.int64)),
                            torch.as_tensor(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert int(trng.hash_combine(5, 9)) == int(jrng.hash_combine(5, 9))
