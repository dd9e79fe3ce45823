"""Schoolbook multipliers: Star baseline, Feedback (FB) and Feed-Forward (FF).

PyTorch counterparts of the reference's ``core/schoolbook.py`` (the
paper's Section III architectures).  Folding over CT cycles is a Python
loop over chunks of the second operand B: every iteration re-uses the
same PPM + compressor (+ final adder for FB) computation, as the
hardware re-uses the same silicon over CT clock cycles.  These are also
the plain versions the ``mcim_fold`` CUDA kernels are held against.
"""
from __future__ import annotations

import torch

from . import limbs as L


def _chunk_limbs(lb: int, ct: int) -> int:
    """Limbs per B-chunk for a CT-cycle folded design (ceil(LB/CT))."""
    return -(-lb // ct)


def _chunks(a: torch.Tensor, b: torch.Tensor, ct: int):
    """Broadcast a/b to one batch and cut B (zero-padded) into CT chunks."""
    la, lb = a.shape[-1], b.shape[-1]
    chunk = _chunk_limbs(lb, ct)
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(batch + (la,))
    b_pad = L.pad_limbs(b, chunk * ct).expand(batch + (chunk * ct,))
    return a, [b_pad[..., t * chunk:(t + 1) * chunk] for t in range(ct)], \
        chunk, batch


def star_mul(a: torch.Tensor, b: torch.Tensor,
             adder: str = "1ca") -> torch.Tensor:
    """Single-cycle multiplier (the '*' operator / "Star" baseline)."""
    la, lb = a.shape[-1], b.shape[-1]
    return L.FINAL_ADDERS[adder](L.ppm(a, b), la + lb)


def feedback_mul(a: torch.Tensor, b: torch.Tensor, ct: int = 2,
                 adder: str = "1ca") -> torch.Tensor:
    """Feedback (FB) architecture, paper Fig. 1.  Any CT >= 2.

    Per cycle t (LSB chunk first): PPM(A, B_t) plus the previous
    normalized result shifted down by one chunk, a final adder over the
    M + N/CT (+carry) window, and the low chunk limbs retire.  After CT
    cycles the remaining high limbs complete the product.
    """
    if ct < 2:
        raise ValueError("FB is a multi-cycle design: ct >= 2")
    if adder != "1ca":
        raise ValueError("FB supports only the 1CA final adder (feedback loop)")
    la, lb = a.shape[-1], b.shape[-1]
    a, b_chunks, chunk, batch = _chunks(a, b, ct)
    width = la + chunk + 1            # compressor / final adder width
    r = torch.zeros(batch + (width,), dtype=L.LIMB_DTYPE, device=a.device)
    low = []
    for b_t in b_chunks:
        cols = L.ppm(a, b_t)                          # (..., la+chunk)
        acc = L.compress([(cols, 0), (r[..., chunk:], 0)], width)
        r = L.final_adder_1ca(acc, width)
        low.append(r[..., :chunk])                    # retire low limbs
    out = torch.cat(low + [r[..., chunk:]], dim=-1)
    return out[..., :la + lb]


def feedforward_mul(a: torch.Tensor, b: torch.Tensor, ct: int = 2,
                    adder: str = "1ca") -> torch.Tensor:
    """Feed-Forward (FF) architecture, paper Fig. 2.

    All CT partial-product passes of the shared PPM run first (held in
    the register file), then one 2*CT:2 compressor and final adder.
    """
    if ct < 2:
        raise ValueError("FF is a multi-cycle design: ct >= 2")
    la, lb = a.shape[-1], b.shape[-1]
    a, b_chunks, chunk, _ = _chunks(a, b, ct)
    parts = [L.ppm(a, b_t) for b_t in b_chunks]       # shared PPM
    width = la + ct * chunk + 1
    acc = L.compress([(p, t * chunk) for t, p in enumerate(parts)], width)
    return L.FINAL_ADDERS[adder](acc, la + lb)
