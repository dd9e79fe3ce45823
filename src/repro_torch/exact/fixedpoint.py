"""Bit-exact deterministic reductions via 128-bit fixed-point limbs.

Counterpart of the reference's ``exact/fixedpoint.py``.  Floating-point
summation is not associative, so data-parallel gradient all-reduces give
run-to-run (and topology-to-topology) different bits.  Each float32 is
encoded as 128-bit two's-complement fixed point (16-bit limbs, 2^-40
resolution), reduced in the integer domain (exact, associative,
order-invariant: carry-free column sums), and carry-propagated once at
the end.

Dtypes follow :mod:`repro_torch.core.limbs`: limbs are ``torch.int32`` at
the public functions, column sums ``torch.int64`` inside.  Where the
reference's ``uint32`` lanes wrap (the column sums of :func:`exact_sum`,
the int32 -> uint32 view after :func:`exact_psum`, the carry pass) the
port masks with ``U32`` explicitly.  :func:`fixed_to_f32` adds the limb
terms in one fixed order, lowest limb first (the order XLA's reduction
takes on the CPU), so the CPU and the card give the same bits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..core import limbs as L

N_LIMBS = 8          # 128 bits
FRAC_BITS = 40       # resolution 2^-40; integer headroom 2^(87)
U32 = 0xFFFFFFFF
_TOP_BIT = 0x8000


def _carry_u32(cols: torch.Tensor) -> torch.Tensor:
    """The reference's 1CA on uint32 lanes: int64 columns below 2^32 ->
    canonical limbs (int64), each column-plus-carry wrapped mod 2^32."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[..., 0])
    for k in range(cols.shape[-1]):
        tot = (cols[..., k] + carry) & U32
        out[..., k] = tot & L.MASK
        carry = tot >> L.RADIX_BITS
    return out


def _complement(limbs: torch.Tensor) -> torch.Tensor:
    """Two's complement of canonical limbs: NOT, +1, one carry pass."""
    comp = L.MASK - limbs
    comp[..., 0] += 1
    return _carry_u32(comp)


def f32_to_fixed(x: torch.Tensor, frac_bits: int = FRAC_BITS,
                 n_limbs: int = N_LIMBS) -> torch.Tensor:
    """float32 (...,) -> (..., n_limbs) int32 two's-complement fixed point
    (canonical 16-bit limbs; non-finite values encode as 0)."""
    x = x.to(torch.float32)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    sign = x < 0
    m, e = torch.frexp(x.abs())                # |x| = m * 2^e, m in [0.5, 1)
    mi = torch.round(m * (1 << 24)).to(torch.int64)      # 24-bit mantissa
    shift = e.to(torch.int64) - 24 + frac_bits           # value = mi * 2^shift
    # negative shift: truncate low bits of the mantissa
    neg = torch.clamp(-shift, min=0)
    mi = torch.where(neg < 32, mi >> torch.clamp(neg, max=31),
                     torch.zeros_like(mi))
    shift = torch.clamp(shift, min=0)

    k0 = shift // 16                           # limb offset
    r = shift % 16                             # intra-limb bit offset
    s_lo = (mi & L.MASK) << r                  # < 2^31
    s_hi = (mi >> 16) << r                     # < 2^24
    p0 = s_lo & L.MASK
    p1 = (s_lo >> 16) + (s_hi & L.MASK)        # <= 0xFFFF
    p2 = s_hi >> 16

    k = torch.arange(n_limbs, device=x.device)
    tgt = k0[..., None]
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    mag = (torch.where(k == tgt, p0[..., None], zero)
           + torch.where(k == tgt + 1, p1[..., None], zero)
           + torch.where(k == tgt + 2, p2[..., None], zero))
    return torch.where(sign[..., None], _complement(mag),
                       mag).to(L.LIMB_DTYPE)


def fixed_to_f32(limbs: torch.Tensor,
                 frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """(..., n_limbs) two's-complement column sums (any integer dtype,
    values in [0, 2^32)) -> float32, the same bits on every device."""
    n = limbs.shape[-1]
    norm = _carry_u32(limbs.to(torch.int64))   # canonical mod 2^(16n)
    neg = (norm[..., -1] & _TOP_BIT) != 0
    mag = torch.where(neg[..., None], _complement(norm), norm)
    terms = mag.to(torch.float32) * torch.tensor(
        [2.0 ** (16 * k - frac_bits) for k in range(n)],
        dtype=torch.float32, device=limbs.device)
    val = terms[..., 0]
    for k in range(1, n):                      # lowest limb first
        val = val + terms[..., k]
    return torch.where(neg, -val, val)


def fixed_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-free accumulation (columns stay < 2^32 for < 2^16 terms);
    int64 column sums, wrapped mod 2^32 as the reference's uint32."""
    return (a.to(torch.int64) + b.to(torch.int64)) & U32


def exact_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Order-invariant sum over ``axis`` of ``x``: same bits for any
    permutation.  A negative ``axis`` counts from the last axis of ``x``
    (the reference hands it to the limb-extended encoding, where -1
    would name the limbs; no caller passes one)."""
    fixed = f32_to_fixed(x)
    axis = axis % x.ndim                       # the limb axis comes last
    acc = fixed.to(torch.int64).sum(dim=axis) & U32
    return fixed_to_f32(acc)


def exact_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Deterministic all-reduce sum over ``group`` (the default process
    group when None): every rank gets the same bits, whatever the
    ranks' order.  The counterpart of the reference's ``psum`` over a
    mesh axis; an int32 ``all_reduce`` of the fixed-point limbs."""
    acc = f32_to_fixed(x)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return fixed_to_f32(acc.to(torch.int64) & U32)


def exact_tree_sum(trees: list):
    """Deterministic elementwise sum of a list of pytrees (microbatches)."""
    leaves = [pytree.tree_flatten(t)[0] for t in trees]
    spec = pytree.tree_flatten(trees[0])[1]
    summed = [exact_sum(torch.stack([leaf.to(torch.float32)
                                     for leaf in column]), axis=0)
              for column in zip(*leaves)]
    return pytree.tree_unflatten(summed, spec)
