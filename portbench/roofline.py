"""The frozen yardstick of a bank round: its fixed work and the H100's peaks.

A round of ``batch`` products of ``la`` x ``lb`` 16-bit limbs must at
least read each operand once and write each product once, and make
``la * lb`` limb multiply-adds a product.  Counted so, on purpose, and
not from the program's launch contracts: the contract counts padded rows
and would change with any change to the kernel, so a share of it could
not compare two commits.  Imports nothing of the program.
"""
from __future__ import annotations

#: HBM bandwidth of one H100 SXM (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: int32 multiply-add peak outside the tensor cores: 132 SMs x 64 lanes x
#: 1.98 GHz (the figure the port's kernel table uses), ops/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9
LIMB_BYTES = 4


def round_bytes(batch: int, la: int, lb: int) -> int:
    """Each operand read once and each (la + lb)-limb product written once."""
    return batch * (la + lb + (la + lb)) * LIMB_BYTES


def round_ops(batch: int, la: int, lb: int) -> int:
    """Limb multiply-adds of a schoolbook product, ``la * lb`` a product."""
    return batch * la * lb


def round_bound_s(batch: int, la: int, lb: int) -> float:
    """The least time the card could take for the round, in seconds."""
    return max(round_bytes(batch, la, lb) / HBM_BYTES_PER_S,
               round_ops(batch, la, lb) / INT32_OPS_PER_S)
