"""Stateless counter-based sampler: every sample is a pure hash of
(seed, lane, dim), bit-identical to the JAX package's `core/rng.py`.

PyTorch has no usable uint32 shift or add, so the u32 arithmetic runs in
int64 masked to 32 bits. Every product is masked before the next one: a
32-bit value times a 30-bit constant stays below 2^63.

The PCG-family hash is from Jarzynski & Olano, "Hash Functions for GPU
Rendering" (JCGT 2020).
"""
from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device

MASK32 = 0xFFFFFFFF


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    x = (x * 747796405 + 2891336453) & MASK32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash_combine(a, b) -> torch.Tensor:
    """Mix two u32 streams (boost-style golden-ratio combine, then PCG)."""
    dev = a.device if isinstance(a, torch.Tensor) else (
        b.device if isinstance(b, torch.Tensor) else None
    )
    a = _u32(a, dev)
    b = _u32(b, dev)
    h = (a ^ ((b + 0x9E3779B9 + (a << 6) + (a >> 2)) & MASK32))
    return _pcg_hash(h)


def random_bits(seed, lane, dim) -> torch.Tensor:
    """u32 random bits (as int64 in [0, 2^32)) of (seed, lane, dim)."""
    return _pcg_hash(hash_combine(hash_combine(seed, lane), dim))


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    # top 24 bits: exactly representable in f32, in [0, 1)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform(seed, lane, dim) -> torch.Tensor:
    """f32 uniform in [0, 1) from (seed, lane, dim)."""
    return _to_uniform(random_bits(seed, lane, dim))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Independent sampler: a seed and global lane ids. `dim` is chosen by
    the caller (see `bounce_dim`). `key` caches hash_combine(seed, lane),
    the dim-independent half of every draw."""

    seed: int
    lane: torch.Tensor  # [N] int64
    key: torch.Tensor   # [N] int64, hash_combine(seed, lane)

    @staticmethod
    def create(seed: int, wavefront_size: int, lane_offset: int = 0,
               device="cuda") -> "Sampler":
        lane = torch.arange(wavefront_size, dtype=torch.int64,
                            device=resolve_device(device)) + int(lane_offset)
        return Sampler.from_lanes(seed, lane)

    @staticmethod
    def from_lanes(seed: int, lane: torch.Tensor) -> "Sampler":
        seed = int(seed) & MASK32
        lane = _u32(lane)
        return Sampler(seed=seed, lane=lane, key=hash_combine(seed, lane))

    def next_1d(self, dim) -> torch.Tensor:
        """Uniforms of dimension `dim`: an int, or an int64 tensor [N] of
        per-lane dimensions."""
        return _to_uniform(_pcg_hash(hash_combine(self.key, dim)))

    def next_2d(self, dim) -> torch.Tensor:
        return torch.stack([self.next_1d(dim), self.next_1d(dim + 1)], dim=-1)

    def fork(self, salt: int) -> "Sampler":
        seed = int(hash_combine(self.seed, salt))
        return Sampler.from_lanes(seed, self.lane)


# ---------------------------------------------------------------------------
# Pixel samplers of the camera dimensions (the JAX package's CMJ, Halton,
# scrambled (0,2)-sequence and orthogonal-array points; Kensler, "Correlated
# Multi-Jittered Sampling", Pixar TM 13-01; Jarosz et al. 2019). Every
# function takes u32 values held in int64 tensors and matches JAX's u32
# arithmetic bit for bit; the bounce dimensions stay independent.
# ---------------------------------------------------------------------------

SAMPLER_INDEPENDENT = "independent"
SAMPLER_STRATIFIED = "stratified"
SAMPLER_MULTIJITTER = "multijitter"
SAMPLER_LD = "ldsampler"
SAMPLER_HALTON = "halton"
SAMPLER_ORTHOGONAL = "orthogonal"
SAMPLER_TYPES = (SAMPLER_INDEPENDENT, SAMPLER_STRATIFIED,
                 SAMPLER_MULTIJITTER, SAMPLER_LD, SAMPLER_HALTON,
                 SAMPLER_ORTHOGONAL)

_TO_UNIT32 = 2.3283064365386963e-10  # 2^-32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for u32 a (int64 tensor) and a u32 constant c, in
    two 16-bit halves of c so that no product leaves int64."""
    c &= MASK32
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _cmj_permute(i, l: int, p):
    """Pseudorandom permutation of [0, l) keyed by p (u32 tensors i, p; l
    a Python int): four rounds of xor-key, odd multiply and xor-shift masked
    to the next power of two, cycle-walked back into [0, l), then rotated
    by p. JAX walks with a while loop until every lane is in range; a walk
    from a value in range visits each out-of-range value at most once, so
    a fixed 2^k - l masked rounds give the same result with no host
    synchronisation (none at all where l is a power of two)."""
    i, p = _u32(i), _u32(p)
    w = (int(l) - 1) & MASK32
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    keys = [_pcg_hash((p + ((0x9E3779B9 * (r + 1)) & MASK32)) & MASK32)
            for r in range(4)]

    def scramble(x):
        for k in keys:
            x = (x ^ (k & w)) & w
            x = _mul32(x, 0x6935FA69) & w   # odd multiplier: invertible
            x = (x ^ (x >> 3)) & w          # xorshift: invertible
            x = _mul32(x, 0x74DCCA9B) & w
            x = (x ^ (x >> 7)) & w
        return x

    i = scramble(i)
    for _ in range(w + 1 - int(l)):
        i = torch.where(i >= l, scramble(i), i)
    return ((i + p) & MASK32) % int(l)


def _cmj_randfloat(i, p) -> torch.Tensor:
    return _to_uniform(_pcg_hash(hash_combine(i, p)))


def cmj_sample_2d(s, spp: int, pattern) -> torch.Tensor:
    """Correlated multi-jittered 2D sample s of spp (a Python int) for the
    u32 pattern ids `pattern` (broadcastable with s): [..., 2]."""
    import math

    m = max(int(math.sqrt(spp)), 1)
    n = (spp + m - 1) // m
    pattern = _u32(pattern)
    s = _cmj_permute(s, spp, _mul32(pattern, 0x51633E2D))
    sx = _cmj_permute(s % m, m, _mul32(pattern, 0x68BC21EB))
    sy = _cmj_permute(s // m, n, _mul32(pattern, 0x02E5BE93))
    jx = _cmj_randfloat(s, _mul32(pattern, 0x967A889B))
    jy = _cmj_randfloat(s, _mul32(pattern, 0x368CC8B7))
    f32 = torch.float32
    x = (sx.to(f32) + (sy.to(f32) + jx) / n) / m
    y = (s.to(f32) + jy) / spp
    return torch.stack([x, y], dim=-1)


def _bit_reverse32(i) -> torch.Tensor:
    i = _u32(i)
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    return ((i << 16) | (i >> 16)) & MASK32


def _radical_inverse_base2(i) -> torch.Tensor:
    """Van der Corput sequence: the bit reversal over 2^32."""
    return _bit_reverse32(i).to(torch.float32) * _TO_UNIT32


def _radical_inverse_base3(i, digits: int = 20) -> torch.Tensor:
    """Base-3 radical inverse over a fixed 20 digits (3^20 > 2^31), each
    digit's product and sum rounded on its own in float32."""
    i = _u32(i)
    f = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    inv = torch.tensor(1.0 / 3.0, dtype=torch.float32)
    scale = torch.full(i.shape, float(inv), dtype=torch.float32,
                       device=i.device)
    for _ in range(digits):
        f = f + (i % 3).to(torch.float32) * scale
        i = i // 3
        scale = scale * inv
    return f


def halton_2d(s, pattern) -> torch.Tensor:
    """The (base 2, base 3) radical inverses of sample index s with a
    Cranley-Patterson rotation per u32 pattern: [..., 2]."""
    pattern = _u32(pattern)
    rx = _cmj_randfloat(torch.zeros_like(pattern),
                        _mul32(pattern, 0x9E3779B1))
    ry = _cmj_randfloat(torch.ones_like(pattern),
                        _mul32(pattern, 0x85EBCA77))
    x = torch.fmod(_radical_inverse_base2(s) + rx, 1.0)
    y = torch.fmod(_radical_inverse_base3(s) + ry, 1.0)
    return torch.stack([x, y], dim=-1)


def _sobol2(i, scramble) -> torch.Tensor:
    """The XOR-scrambled second dimension of the Sobol' (0,2)-sequence:
    32 steps over the direction numbers v_{k+1} = v_k ^ (v_k >> 1)."""
    i = _u32(i)
    res = _u32(scramble)
    v = 0x80000000
    for k in range(32):
        res = res ^ (((i >> k) & 1) * v)
        v ^= v >> 1
    return res


def ld_2d(s, pattern) -> torch.Tensor:
    """Point s of the scrambled (0,2)-sequence (x the van der Corput
    sequence, y Sobol' dimension 2, each XOR-scrambled per u32 pattern):
    [..., 2]."""
    s, pattern = _u32(s), _u32(pattern)
    scr1 = _pcg_hash((_mul32(pattern, 0x9E3779B1) + 0x2545F491) & MASK32)
    scr2 = _pcg_hash((_mul32(pattern, 0x85EBCA77) + 0x633D9B4F) & MASK32)
    xb = _bit_reverse32(s) ^ scr1
    yb = _sobol2(s, scr2)
    return torch.stack([xb.to(torch.float32) * _TO_UNIT32,
                        yb.to(torch.float32) * _TO_UNIT32], dim=-1)


def orthogonal_2d(s, spp: int, pattern) -> torch.Tensor:
    """Orthogonal-array 2D sample s by the Bose construction of strength 2
    on a ceil(sqrt(spp))^2 grid, for u32 pattern ids: [..., 2]."""
    import math

    res = max(int(math.ceil(math.sqrt(spp))), 1)
    pattern = _u32(pattern)
    i = _cmj_permute(s, res * res, pattern)
    a0, a1 = i // res, i % res
    p1, p2 = pattern, _mul32(pattern, 2)
    sx = _cmj_permute(a0, res, _mul32(p1, 0x51633E2D))
    ssx = _cmj_permute(a1, res, _mul32(p1, 0x68BC21EB))
    sy = _cmj_permute(a1, res, _mul32(p2, 0x51633E2D))
    ssy = _cmj_permute(a0, res, _mul32(p2, 0x68BC21EB))
    jx = _cmj_randfloat(i, _mul32(pattern, 0x967A889B))
    jy = _cmj_randfloat(i, _mul32(pattern, 0x368CC8B7))
    f32 = torch.float32
    x = (sx.to(f32) + (ssx.to(f32) + jx) / res) / res
    y = (sy.to(f32) + (ssy.to(f32) + jy) / res) / res
    return torch.stack([x, y], dim=-1)


# Fixed dimension map shared with the JAX package (camera: the film jitter
# and the aperture sample, wavelengths, then a stride of 12 dims per
# bounce).
DIMS_PER_BOUNCE = 12
DIM_CAMERA = 0
DIM_WAVELENGTH = 4
DIM_BOUNCE_BASE = 8


def bounce_dim(bounce, offset: int):
    """Dimension `offset` of bounce `bounce` (an int, or an int64 tensor of
    per-lane depths)."""
    return DIM_BOUNCE_BASE + bounce * DIMS_PER_BOUNCE + offset
