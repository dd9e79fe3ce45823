"""Karatsuba folded multiplier (paper Sec. III-D, Figs. 3 and 4), in PyTorch.

Counterpart of the reference's ``core/karatsuba.py``:

  * the top level is folded over CT=3 cycles: one shared PPM computes
    T0 = A0*B0, T1 = A1*B1, T2 = (A0+A1)*(B0+B1) on consecutive cycles
    (a Python loop over the three stacked operand pairs);
  * the shared PPM may itself be a combinational Karatsuba PPM (Fig. 4):
    three recursively smaller PPMs and a 10:2 compressor; ``levels``
    counts all Karatsuba levels including the folded top one (Karat-K);
  * subtractions are two's complement: NOT the limbs and add 1 through
    the compressor; the 2**(16*W) wrap vanishes in the final adder's
    fixed-width truncation.

As in the reference, each T_i is normalized (a final-adder pass) before
the combiner, since complementing a column-sum vector is not closed
over uint32.
"""
from __future__ import annotations

import torch

from . import limbs as L


def _split_pad(x: torch.Tensor, half: int, total: int):
    """Split (..., total) limbs into low/high halves of ``half`` limbs."""
    x = L.pad_limbs(x, total)
    return x[..., :half], x[..., half:]


def _halves(a: torch.Tensor, b: torch.Tensor):
    """Even split point, operand halves and the (half+1)-limb sums."""
    n = max(a.shape[-1], b.shape[-1])
    n += n % 2
    half = n // 2
    a0, a1 = _split_pad(a, half, n)
    b0, b1 = _split_pad(b, half, n)
    sa = L.add_canonical(a0, a1, half + 1)
    sb = L.add_canonical(b0, b1, half + 1)
    return half, (a0, a1, sa), (b0, b1, sb)


def karatsuba_ppm(a: torch.Tensor, b: torch.Tensor,
                  levels: int) -> torch.Tensor:
    """Combinational Karatsuba PPM (paper Fig. 4): int64 carry-save
    columns of a*b.  levels == 0 is the plain schoolbook PPM."""
    la, lb = a.shape[-1], b.shape[-1]
    if levels == 0 or la <= 1 or lb <= 1:
        return L.ppm(a, b)
    half, (a0, a1, sa), (b0, b1, sb) = _halves(a, b)
    width = la + lb
    t0 = L.final_adder_1ca(karatsuba_ppm(a0, b0, levels - 1), 2 * half)
    t1 = L.final_adder_1ca(karatsuba_ppm(a1, b1, levels - 1), 2 * half)
    t2 = L.final_adder_1ca(karatsuba_ppm(sa, sb, levels - 1), 2 * half + 2)
    neg_t0, one0 = L.negate_cols(t0, half, width)
    neg_t1, one1 = L.negate_cols(t1, half, width)
    return L.compress(
        [(t0, 0), (t1, 2 * half), (t2, half),
         (neg_t0, 0), (one0, 0), (neg_t1, 0), (one1, 0)],
        width)


def karatsuba_mul(a: torch.Tensor, b: torch.Tensor, levels: int = 1,
                  ct: int = 3, adder: str = "1ca") -> torch.Tensor:
    """CT=3 folded Karatsuba multiplier (paper Fig. 3), Karat-``levels``.

    The three half-size multiplications run on ONE shared PPM over three
    cycles; a feedback loop around the compressor accumulates the
    placed/complemented terms; the final adder runs once.
    """
    if ct != 3:
        raise ValueError("the Karatsuba MCIM is optimal for (and fixed to) CT=3")
    if levels < 1:
        raise ValueError("levels >= 1")
    la, lb = a.shape[-1], b.shape[-1]
    half, (a0, a1, sa), (b0, b1, sb) = _halves(a, b)
    # the shared PPM's (half+1)-limb port width -- one PPM, three cycles
    ops = ((L.pad_limbs(a0, half + 1), L.pad_limbs(b0, half + 1)),
           (L.pad_limbs(a1, half + 1), L.pad_limbs(b1, half + 1)),
           (sa, sb))
    width = la + lb

    def place(idx, t):
        if idx == 2:                                  # + T2<<half
            return L.compress([(t, half)], width)
        neg, one = L.negate_cols(t, half, width)      # - T<<half
        shift = 0 if idx == 0 else 2 * half           # + T0<<0 / T1<<2h
        return L.compress([(t, shift), (neg, 0), (one, 0)], width)

    acc = None
    for idx, (av, bv) in enumerate(ops):
        cols = karatsuba_ppm(av, bv, levels - 1)      # shared PPM
        t = L.final_adder_1ca(cols, 2 * half + 2)
        contrib = place(idx, t)
        acc = contrib if acc is None else acc + contrib   # compressor loop
    return L.FINAL_ADDERS[adder](acc, la + lb)
