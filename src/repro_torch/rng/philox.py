"""Philox-4x32-10 counter-based RNG built on the MCIM 32x32->64 multiply.

Counterpart of the reference's ``rng/philox.py``.  The Philox round
needs mulhi/mullo of 32-bit lanes; as in the reference, every product
goes through the folded 16-bit-limb multiplier
(:func:`repro_torch.core.mul32x32_64`).  Counter-based RNG makes the
data pipeline order-independent and resumable: sample i of epoch e is a
pure function of (seed, e, i).

uint32 lanes are ``torch.int64`` holding values in [0, 2^32) (PyTorch
has no uint32 arithmetic on the CPU); the key schedule's additions and
the offsets wrap mod 2^32 through an explicit mask.  Every function runs
on the device its counters or offsets lie on.
"""
from __future__ import annotations

import torch

from ..core import mul32x32_64

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
W32_0 = 0x9E3779B9
W32_1 = 0xBB67AE85
U32 = 0xFFFFFFFF


def philox4x32(counter: torch.Tensor, key: torch.Tensor,
               rounds: int = 10) -> torch.Tensor:
    """counter: (..., 4), key: (..., 2) uint32 values in any integer dtype
    -> (..., 4) int64 uint32 values."""
    counter, key = counter.to(torch.int64), key.to(torch.int64)
    c0, c1, c2, c3 = (counter[..., i] for i in range(4))
    k0, k1 = key[..., 0], key[..., 1]
    m0 = torch.full_like(c0, PHILOX_M0)
    m1 = torch.full_like(c2, PHILOX_M1)
    for _ in range(rounds):
        lo0, hi0 = mul32x32_64(m0, c0)
        lo1, hi1 = mul32x32_64(m1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
        k0 = (k0 + W32_0) & U32
        k1 = (k1 + W32_1) & U32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def random_u32(seed: int, stream: int, offsets: torch.Tensor) -> torch.Tensor:
    """Deterministic uint32 per offset: (N,) int -> (N, 4) int64 lanes."""
    offsets = offsets.to(torch.int64) & U32
    zeros = torch.zeros_like(offsets)
    counter = torch.stack(
        [offsets, zeros, torch.full_like(offsets, stream & U32), zeros],
        dim=-1)
    key = torch.tensor([seed & U32, (seed >> 32) & U32], dtype=torch.int64,
                       device=offsets.device).expand(offsets.shape + (2,))
    return philox4x32(counter, key)


def random_uniform(seed: int, stream: int,
                   offsets: torch.Tensor) -> torch.Tensor:
    """(N,) offsets -> (N,) float32 in [0, 1]: the first lane rounded to
    float32, times 2^-32 (the reference's arithmetic)."""
    bits = random_u32(seed, stream, offsets)[..., 0]
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def random_tokens(seed: int, stream: int, offsets: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Deterministic synthetic token ids (int32) for the synthetic
    pipeline."""
    bits = random_u32(seed, stream, offsets)[..., 0]
    return (bits % vocab).to(torch.int32)
