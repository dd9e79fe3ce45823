"""Limb representation of wide unsigned integers, in PyTorch.

The PyTorch counterpart of the reference package's ``core/limbs.py``.
An N-bit unsigned integer is a little-endian vector of 16-bit *limbs*
on the last axis; a "carry-save" value is a vector of *column sums* in
radix 2**16 whose columns may exceed 16 bits (the paper's carry-save
rows):

  * PPM         == limb-wise 16x16->32 products split into lo/hi halves,
                   added into columns without carry propagation.
  * compressor  == addition of column-sum vectors (deferred carries).
  * final adder == one carry-propagation pass back to 16-bit limbs.

Dtype plan:

  * canonical limbs cross the public functions as ``torch.int32``; every
    limb is below 2**16, so the reference's ``uint32`` arrays convert
    losslessly (:func:`from_numpy`);
  * carry-save column sums are ``torch.int64``: a column can approach
    2**32, which int32 cannot hold, and PyTorch has no ``uint32``
    addition or shift on the CPU;
  * the final adders truncate mod 2**(16*out_limbs) explicitly, as the
    reference's fixed-width uint32 lanes do.

The column bounds the reference's interval analyzer proves (every
column < 2**32) make these int64 sums equal, bit for bit, to the uint32
sums of the reference and of the CUDA kernels.

All ops are batched over leading axes; limb 0 is least significant.
"""
from __future__ import annotations

import numpy as np
import torch

RADIX_BITS = 16
RADIX = 1 << RADIX_BITS
MASK = RADIX - 1
#: dtype of canonical limbs at the port's public functions
LIMB_DTYPE = torch.int32
#: dtype of carry-save column sums inside the plain PyTorch paths
COL_DTYPE = torch.int64

#: Largest value a carry-save column may reach: columns live in uint32
#: inside the kernels.
U32_MAX = (1 << 32) - 1


def n_limbs_for_bits(bits: int) -> int:
    """Number of 16-bit limbs needed to hold ``bits`` bits."""
    return -(-bits // RADIX_BITS)


def max_limb_value(bits: int) -> int:
    """Worst-case value of any single limb of a ``bits``-bit operand."""
    if bits >= RADIX_BITS:
        return MASK
    return (1 << bits) - 1


def MAX_SAFE_COLUMN_TERMS(bits_a: int, bits_b: int) -> int:
    """Carry-save terms one uint32 column can absorb for a bits_a x bits_b
    design before overflow becomes possible (the coarse budget asserted
    at the construction sites below)."""
    prod = max_limb_value(bits_a) * max_limb_value(bits_b)
    term_max = max(min(prod, MASK), prod >> RADIX_BITS, 1)
    return U32_MAX // term_max


# ---------------------------------------------------------------------------
# Host-side conversion (numpy / Python ints, as in the reference).
# ---------------------------------------------------------------------------

def to_limbs(value: int, n_limbs: int) -> np.ndarray:
    """Convert a Python int to a little-endian uint32 limb vector."""
    if value < 0:
        raise ValueError("unsigned only")
    if value >> (RADIX_BITS * n_limbs):
        raise ValueError(f"{value} does not fit in {n_limbs} limbs")
    out = np.zeros((n_limbs,), dtype=np.uint32)
    for k in range(n_limbs):
        out[k] = (value >> (RADIX_BITS * k)) & MASK
    return out


def _host(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        return limbs.detach().cpu().numpy()
    return np.asarray(limbs)


def from_limbs(limbs) -> int:
    """Convert a 1-D limb vector (canonical or carry-save) to a Python int."""
    limbs = _host(limbs)
    total = 0
    for k in range(limbs.shape[-1]):
        total += int(limbs[k]) << (RADIX_BITS * k)
    return total


def batch_to_limbs(values, n_limbs: int) -> np.ndarray:
    """Convert an iterable of Python ints to a (B, n_limbs) uint32 array."""
    return np.stack([to_limbs(int(v), n_limbs) for v in values])


def batch_from_limbs(limbs) -> list:
    limbs = _host(limbs)
    flat = limbs.reshape(-1, limbs.shape[-1])
    return [from_limbs(row) for row in flat]


def random_limbs(rng: np.random.Generator, shape, bits: int) -> np.ndarray:
    """Uniform random ``bits``-bit integers as uint32 limb arrays.

    Draws exactly what the reference's ``random_limbs`` draws from the
    same generator, so both packages see the same operands.
    """
    n = n_limbs_for_bits(bits)
    out = rng.integers(0, RADIX, size=tuple(shape) + (n,), dtype=np.uint32)
    rem = bits - (n - 1) * RADIX_BITS
    out[..., -1] &= (1 << rem) - 1
    return out


def from_numpy(arr, device) -> torch.Tensor:
    """Canonical limbs (any integer numpy array, e.g. the reference's
    uint32) as an int32 tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > MASK:
        raise ValueError("from_numpy takes canonical 16-bit limbs")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def _cols(x: torch.Tensor) -> torch.Tensor:
    return x.to(COL_DTYPE)


# ---------------------------------------------------------------------------
# PPM: partial-product multiplier producing carry-save column sums.
# ---------------------------------------------------------------------------

def ppm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Partial-product multiplier: carry-save column sums of a*b.

    a: (..., LA) canonical limbs, b: (..., LB) canonical limbs;
    returns (..., LA+LB) int64 column sums (no carry propagation).
    """
    la, lb = a.shape[-1], b.shape[-1]
    assert 2 * min(la, lb) <= MAX_SAFE_COLUMN_TERMS(la * RADIX_BITS,
                                                    lb * RADIX_BITS), \
        f"{la}x{lb}-limb PPM exceeds the uint32 carry-save term budget"
    a, b = torch.broadcast_tensors(_cols(a)[..., :, None],
                                   _cols(b)[..., None, :])
    prod = a * b                                   # exact: < 2**32
    lo, hi = prod & MASK, prod >> RADIX_BITS       # (..., LA, LB)
    cols = torch.zeros(prod.shape[:-2] + (la + lb,), dtype=COL_DTYPE,
                       device=prod.device)
    for j in range(lb):                            # lo of a[i]*b[j] -> i+j
        cols[..., j:j + la] += lo[..., j]
        cols[..., j + 1:j + la + 1] += hi[..., j]
    return cols


# ---------------------------------------------------------------------------
# Compressor: carry-save addition of column-sum vectors.
# ---------------------------------------------------------------------------

def compress(terms, width: int) -> torch.Tensor:
    """Sum carry-save vectors ``[(cols, shift_limbs), ...]`` into
    ``width`` int64 columns (pure column addition, no carries)."""
    assert len(terms) <= MAX_SAFE_COLUMN_TERMS(RADIX_BITS, RADIX_BITS), \
        f"compress of {len(terms)} terms exceeds the uint32 term budget"
    batch = torch.broadcast_shapes(*[t[0].shape[:-1] for t in terms])
    acc = torch.zeros(batch + (width,), dtype=COL_DTYPE,
                      device=terms[0][0].device)
    for cols, shift in terms:
        take = min(cols.shape[-1], width - shift)
        if take <= 0:
            continue
        acc[..., shift:shift + take] += _cols(cols[..., :take])
    return acc


def shift_cols(cols: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """Place ``cols`` at limb offset ``shift`` inside a ``width``-wide vector."""
    return compress([(cols, shift)], width)


def negate_cols(limbs: torch.Tensor, shift: int, width: int):
    """Two's-complement encoding of -(limbs << 16*shift) mod 2**(16*width).

    NOT every column of the placed value, plus a separate +1 column-0
    correction; the wrap-around 2**(16*width) term vanishes in the final
    adder's truncation.  Returns int64 ``(inverted, one)``.
    """
    inverted = MASK - shift_cols(limbs, shift, width)
    one = torch.zeros_like(inverted)
    one[..., 0] = 1
    return inverted, one


# ---------------------------------------------------------------------------
# Final adders.
# ---------------------------------------------------------------------------

def _carry_pass(cols: torch.Tensor, carry: torch.Tensor):
    """Sequential carry propagation over the last axis (the reference's
    ``lax.scan``).  Returns (limbs, carry out)."""
    out = torch.empty_like(cols)
    for k in range(cols.shape[-1]):
        tot = cols[..., k] + carry
        out[..., k] = tot & MASK
        carry = tot >> RADIX_BITS
    return out, carry


def _fit(limbs: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Truncate mod 2**(16*out_limbs) or zero-pad, then cast to int32."""
    width = limbs.shape[-1]
    if out_limbs <= width:
        return limbs[..., :out_limbs].to(LIMB_DTYPE)
    pad = torch.zeros(limbs.shape[:-1] + (out_limbs - width,),
                      dtype=limbs.dtype, device=limbs.device)
    return torch.cat([limbs, pad], dim=-1).to(LIMB_DTYPE)


def final_adder_1ca(cols: torch.Tensor,
                    out_limbs: int | None = None) -> torch.Tensor:
    """Single-pass carry-propagating final adder ("1CA"); the carry out
    of the top column is dropped and the result truncated mod
    2**(16*out_limbs) like fixed-width hardware."""
    cols = _cols(cols)
    out_limbs = cols.shape[-1] if out_limbs is None else out_limbs
    limbs, _ = _carry_pass(cols, torch.zeros_like(cols[..., 0]))
    return _fit(limbs, out_limbs)


def final_adder_3ca(cols: torch.Tensor,
                    out_limbs: int | None = None) -> torch.Tensor:
    """3-cycle resource-shared final adder ("3CA"): one third of the limb
    axis per cycle, the running carry fed back across cycles.
    Functionally identical to 1CA."""
    cols = _cols(cols)
    width = cols.shape[-1]
    out_limbs = width if out_limbs is None else out_limbs
    third = -(-width // 3)
    carry = torch.zeros_like(cols[..., 0])
    pieces = []
    for c in range(-(-width // third)):            # the multi-cycle loop
        seg, carry = _carry_pass(cols[..., c * third:(c + 1) * third],
                                 carry)
        pieces.append(seg)
    return _fit(torch.cat(pieces, dim=-1), out_limbs)


FINAL_ADDERS = {"1ca": final_adder_1ca, "3ca": final_adder_3ca}


# ---------------------------------------------------------------------------
# Canonical-form helpers.
# ---------------------------------------------------------------------------

def add_canonical(a: torch.Tensor, b: torch.Tensor,
                  out_limbs: int) -> torch.Tensor:
    """Exact addition of canonical limb vectors (compressor + 1CA)."""
    width = max(a.shape[-1], b.shape[-1]) + 1
    return final_adder_1ca(compress([(a, 0), (b, 0)], width), out_limbs)


def pad_limbs(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the limb axis up to n limbs."""
    cur = a.shape[-1]
    if cur == n:
        return a
    if cur > n:
        raise ValueError(f"cannot shrink {cur} -> {n}")
    pad = torch.zeros(a.shape[:-1] + (n - cur,), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad], dim=-1)
