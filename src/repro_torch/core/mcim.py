"""Top-level MCIM API: configurable multi-cycle folded integer multiply.

PyTorch counterpart of the reference's ``core/mcim.py``.  ``mcim_mul``
mirrors the paper's generator parameters: architecture (star / fb / ff /
karatsuba), CT (cycle time, = 1/throughput), Karatsuba recursion levels
and final adder.  Operands are batched little-endian 16-bit limbs
(``torch.int32``, see :mod:`.limbs`); this is the "core" capability,
plain PyTorch on whatever device the operands live on.
"""
from __future__ import annotations

import dataclasses

import torch

from . import limbs as L
from .schoolbook import star_mul, feedback_mul, feedforward_mul
from .karatsuba import karatsuba_mul

ARCHS = ("star", "fb", "ff", "karatsuba")


@dataclasses.dataclass(frozen=True)
class MCIMConfig:
    """Generator parameters (paper Sec. IV)."""
    arch: str = "fb"          # star | fb | ff | karatsuba
    ct: int = 2               # cycle time == 1/throughput
    levels: int = 1           # Karatsuba recursion levels (Karat-K)
    adder: str = "1ca"        # 1ca | 3ca
    signed: bool = False      # two's-complement operands

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"arch must be one of {ARCHS}")
        if self.arch == "star" and self.ct != 1:
            raise ValueError("star is single-cycle")
        if self.arch == "karatsuba" and self.ct != 3:
            raise ValueError("Karatsuba MCIM uses CT=3")
        if self.adder not in L.FINAL_ADDERS:
            raise ValueError(f"adder must be one of {tuple(L.FINAL_ADDERS)}")
        if self.adder == "3ca" and self.ct < 3:
            raise ValueError("3CA usable only by designs with TP <= 1/3")


def mcim_mul(a: torch.Tensor, b: torch.Tensor,
             config: MCIMConfig | None = None, **kw) -> torch.Tensor:
    """Multiply limb vectors a (..., LA) x b (..., LB) -> (..., LA+LB).

    Unsigned by default; ``config.signed`` interprets operands as
    two's complement of their limb width and returns the low LA+LB limbs
    of the signed product (wrapping semantics).
    """
    cfg = config or MCIMConfig(**kw)
    if cfg.signed:
        unsigned = dataclasses.replace(cfg, signed=False)
        return signed_correction(a, b, mcim_mul(a, b, unsigned))
    if cfg.arch == "star":
        return star_mul(a, b, adder=cfg.adder)
    if cfg.arch == "fb":
        return feedback_mul(a, b, ct=cfg.ct, adder=cfg.adder)
    if cfg.arch == "ff":
        return feedforward_mul(a, b, ct=cfg.ct, adder=cfg.adder)
    return karatsuba_mul(a, b, levels=cfg.levels, ct=cfg.ct, adder=cfg.adder)


def signed_correction(a: torch.Tensor, b: torch.Tensor,
                      prod: torch.Tensor) -> torch.Tensor:
    """Turn an *unsigned* product into the two's-complement one.

    For P-limb operands interpreted mod 2**(16P):
      signed(a)*signed(b) == a*b - (a<0)*b*2**(16LA) - (b<0)*a*2**(16LB)
    (mod 2**(16(LA+LB))): the sign corrections are subtracted with the
    same compressor/complement machinery as Karatsuba's subtractions.
    The fused bank applies it to the kernel's unsigned products.
    """
    la, lb = a.shape[-1], b.shape[-1]
    width = la + lb
    a_neg = ((a[..., -1] >> (L.RADIX_BITS - 1)) & 1).bool()[..., None]
    b_neg = ((b[..., -1] >> (L.RADIX_BITS - 1)) & 1).bool()[..., None]
    corr_b = torch.where(a_neg, b, torch.zeros_like(b))
    corr_a = torch.where(b_neg, a, torch.zeros_like(a))
    nb, ob = L.negate_cols(corr_b, la, width)
    na, oa = L.negate_cols(corr_a, lb, width)
    acc = L.compress([(prod, 0), (nb, 0), (ob, 0), (na, 0), (oa, 0)], width)
    return L.final_adder_1ca(acc, width)


# Convenience fixed-width wrappers -------------------------------------------

def make_multiplier(bits_a: int, bits_b: int,
                    config: MCIMConfig | None = None, **kw):
    """Return a multiplier for fixed operand widths (bits)."""
    cfg = config or MCIMConfig(**kw)
    la, lb = L.n_limbs_for_bits(bits_a), L.n_limbs_for_bits(bits_b)

    def mul(a, b):
        if a.shape[-1] != la or b.shape[-1] != lb:
            raise ValueError(f"operand limbs {a.shape[-1]}x{b.shape[-1]} "
                             f"do not match {la}x{lb}")
        return mcim_mul(a, b, cfg)

    return mul


def mul32x32_64(a32: torch.Tensor, b32: torch.Tensor, arch: str = "ff",
                ct: int = 2) -> tuple:
    """32x32 -> 64-bit multiply of unsigned 32-bit values via 16-bit limbs.

    ``a32``/``b32`` hold values in [0, 2**32) in any integer dtype wide
    enough (int64 here: PyTorch has no uint32 arithmetic on the CPU).
    Returns int64 ``(lo, hi)`` 32-bit halves.
    """
    a32, b32 = a32.to(torch.int64), b32.to(torch.int64)
    a = torch.stack([a32 & L.MASK, a32 >> 16], dim=-1).to(L.LIMB_DTYPE)
    b = torch.stack([b32 & L.MASK, b32 >> 16], dim=-1).to(L.LIMB_DTYPE)
    cfg = MCIMConfig(arch=arch, ct=ct) if arch != "star" \
        else MCIMConfig(arch="star", ct=1)
    p = mcim_mul(a, b, cfg).to(torch.int64)
    lo = p[..., 0] | (p[..., 1] << 16)
    hi = p[..., 2] | (p[..., 3] << 16)
    return lo, hi
