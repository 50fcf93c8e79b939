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

    def next_1d(self, dim: int) -> torch.Tensor:
        return _to_uniform(_pcg_hash(hash_combine(self.key, dim)))

    def next_2d(self, dim: int) -> torch.Tensor:
        return torch.stack([self.next_1d(dim), self.next_1d(dim + 1)], dim=-1)

    def fork(self, salt: int) -> "Sampler":
        seed = int(hash_combine(self.seed, salt))
        return Sampler.from_lanes(seed, self.lane)


# Fixed dimension map shared with the JAX package (camera, wavelengths,
# then a stride of 12 dims per bounce).
DIMS_PER_BOUNCE = 12
DIM_CAMERA = 0
DIM_WAVELENGTH = 4
DIM_BOUNCE_BASE = 8


def bounce_dim(bounce: int, offset: int) -> int:
    return DIM_BOUNCE_BASE + bounce * DIMS_PER_BOUNCE + offset
