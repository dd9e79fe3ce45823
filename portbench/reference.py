"""The plain reference: schoolbook multiplication of 16-bit limbs.

Operands are canonical little-endian 16-bit limbs in int32 tensors
(``(n, la)`` and ``(n, lb)``); the product is ``(n, la + lb)`` limbs.
Column sums are exact in int64 (at most 16 terms below 2**32 a column),
and one carry pass returns canonical limbs.  Imports nothing of the
program: it is what the program's products are held to.

``acc_dtype=torch.int32`` is the control: the same arithmetic with the
column sums one integer width narrower, the step that would tempt a
faster kernel, which wraps and must come out wrong.
"""
from __future__ import annotations

import torch

RADIX_BITS = 16
MASK = (1 << RADIX_BITS) - 1
#: rows a block, so that a million 8-limb products fit beside the program
BLOCK_ROWS = 1 << 18


def _mul_block(a: torch.Tensor, b: torch.Tensor,
               acc_dtype: torch.dtype) -> torch.Tensor:
    n, la = a.shape
    lb = b.shape[1]
    a = a.to(acc_dtype)
    b = b.to(acc_dtype)
    cols = torch.zeros((n, la + lb), dtype=acc_dtype, device=a.device)
    for i in range(la):
        cols[:, i:i + lb] += a[:, i:i + 1] * b
    out = torch.empty((n, la + lb), dtype=torch.int32, device=a.device)
    carry = torch.zeros((n,), dtype=acc_dtype, device=a.device)
    for j in range(la + lb):
        s = cols[:, j] + carry
        out[:, j] = (s & MASK).to(torch.int32)
        carry = s >> RADIX_BITS
    return out


def mul_limbs(a: torch.Tensor, b: torch.Tensor, *,
              acc_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``(n, la) x (n, lb) -> (n, la + lb)`` int32 limbs, on a's device,
    in blocks of :data:`BLOCK_ROWS` rows."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"operands {tuple(a.shape)} x {tuple(b.shape)} "
                         f"are not two batches of one length")
    if not a.shape[0]:
        return torch.empty((0, a.shape[1] + b.shape[1]), dtype=torch.int32,
                           device=a.device)
    return torch.cat([_mul_block(a[i:i + BLOCK_ROWS], b[i:i + BLOCK_ROWS],
                                 acc_dtype)
                      for i in range(0, a.shape[0], BLOCK_ROWS)])
