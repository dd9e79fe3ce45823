"""Fused bank round in one launch: the CUDA kernel and its plain version.

Counterpart of the reference's ``kernels/bank_fold/kernel.py``, whose
TPU kernel ``_bank_kernel`` is hand-written CUDA in
``csrc/bank_fold.cu`` here, with two paths: TMA bulk copies of row tiles
on a persistent grid, and a coalesced per-thread path for what a bulk
copy cannot take.  :func:`launch_plan` picks the path from the shape and
alignment alone; :func:`fused_bank_mul` launches it for CUDA tensors and
runs :func:`fused_bank_mul_ref`, a windowed schoolbook on int64 lanes,
for CPU tensors; nothing else selects between them.  The launch is the
custom op ``repro_torch::fused_bank_mul_kernel``, whose fake version
gives the product's shape from the blocks' alone (fake tensors see
through it: ``verify.contracts.check_bank_static``).
"""
from __future__ import annotations

import torch

from repro_torch.core import limbs as L
from repro_torch.kernels import _build, _row_tiles
from repro_torch.kernels._row_tiles import PATHS


def _check_shapes(a_blocks, b_blocks, table) -> None:
    if a_blocks.ndim != 3 or b_blocks.ndim != 3 or table.ndim != 3:
        raise ValueError("expected (N_INST, R, LA) x (N_INST, R, LB) "
                         "blocks and an (N_INST, max_steps, 2) table")
    n_inst, rows, _ = a_blocks.shape
    if b_blocks.shape[:2] != (n_inst, rows):
        raise ValueError(f"block shapes {tuple(a_blocks.shape)} and "
                         f"{tuple(b_blocks.shape)} do not match")
    if table.shape[0] != n_inst or table.shape[2] != 2:
        raise ValueError(f"schedule table {tuple(table.shape)} does not "
                         f"match {n_inst} instances")


def fused_bank_mul_ref(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain version: for each instance i and step j, B masked to the
    window ``table[i, j] = (lo, hi)``; the masked partial products are
    accumulated as int64 column sums; one carry pass at the end.
    Returns (N_INST, R, LA+LB) int32 limbs."""
    _check_shapes(a_blocks, b_blocks, table)
    la, lb = a_blocks.shape[-1], b_blocks.shape[-1]
    a = a_blocks.to(L.COL_DTYPE)
    b = b_blocks.to(L.COL_DTYPE)
    table = table.to(a.device)
    limb = torch.arange(lb, device=a.device)
    acc = torch.zeros(a.shape[:-1] + (la + lb,), dtype=L.COL_DTYPE,
                      device=a.device)
    for j in range(table.shape[1]):
        lo, hi = table[:, j, 0:1], table[:, j, 1:2]        # (N_INST, 1)
        bm = b * ((limb >= lo) & (limb < hi))[:, None, :]  # window mask
        for jj in range(lb):
            p = a * bm[..., jj:jj + 1]                     # exact 16x16
            acc[..., jj:jj + la] += p & L.MASK
            acc[..., jj + 1:jj + la + 1] += p >> L.RADIX_BITS
    return L.final_adder_1ca(acc, la + lb)


def launch_plan(n_inst: int, rows: int, la: int, lb: int,
                aligned: bool) -> str:
    """The path of ``csrc/bank_fold.cu`` (one of :data:`PATHS`) that
    takes (N_INST, R, LA) x (N_INST, R, LB) blocks: ``"bulk"`` where TMA
    bulk copies can move every tile (LA = LB in 2, 4, 8, 16, 24;
    16-byte-aligned operands, ``aligned``; R * LA a multiple of 4), else
    ``"per_thread"``.  ``n_inst`` does not change the choice: instance
    i's span starts i * R * LA words in.  See
    :mod:`repro_torch.kernels._row_tiles`."""
    return _row_tiles.plan(rows, la, lb, aligned)


def fused_bank_mul(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """One launch: (N_INST, R, LA) x (N_INST, R, LB) -> (N_INST, R, LA+LB).

    ``table`` is the (N_INST, max_steps, 2) int32 schedule table of
    :meth:`.geometry.SuperGeometry.table`.  Rows are independent
    multiplications (an instance's assigned ops, padded).
    """
    if all(t.device.type == "cpu" for t in (a_blocks, b_blocks, table)):
        return fused_bank_mul_ref(a_blocks, b_blocks, table)
    return fused_bank_mul_kernel(a_blocks, b_blocks, table, path="auto")


# One launch of the path ``path`` (one of :data:`PATHS`, or "auto":
# :func:`launch_plan`'s choice) on CUDA tensors.  :func:`fused_bank_mul`
# passes "auto"; naming a path lets the card compare the paths on one
# shape.  The bulk path raises on blocks only the per-thread path takes.
@torch.library.custom_op("repro_torch::fused_bank_mul_kernel",
                         mutates_args=())
def fused_bank_mul_kernel(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                          table: torch.Tensor, *, path: str
                          ) -> torch.Tensor:
    _check_shapes(a_blocks, b_blocks, table)
    n_inst, rows, la = a_blocks.shape
    lb, max_steps = b_blocks.shape[-1], table.shape[1]
    planned = launch_plan(n_inst, rows, la, lb,
                          _row_tiles.is_aligned(a_blocks, b_blocks))
    if path == "auto":
        path = planned
    if path not in PATHS:
        raise ValueError(f"bank_fold: path must be one of {PATHS}, "
                         f"got {path!r}")
    if path == "bulk" and planned != "bulk":
        raise ValueError(f"bank_fold: {tuple(a_blocks.shape)} x "
                         f"{tuple(b_blocks.shape)} blocks are not bulk "
                         f"copies' spans; the bulk path does not take them")
    _build.check_cuda_operands("bank_fold", a_blocks, b_blocks, table)
    _build.check_limbs("bank_fold", la, lb)
    out = torch.empty((n_inst, rows, la + lb), dtype=L.LIMB_DTYPE,
                      device=a_blocks.device)
    if out.numel() == 0:
        return out
    symbol = "bank_fold_bulk_launch" if path == "bulk" else "bank_fold_launch"
    fn = _build.launcher("bank_fold", symbol, 4, 5)
    _build.launch("bank_fold", fn, (a_blocks, b_blocks, table, out),
                  (n_inst, rows, la, lb, max_steps), path=path,
                  limbs=max(la, lb))
    return out


@fused_bank_mul_kernel.register_fake
def _(a_blocks, b_blocks, table, *, path):
    _check_shapes(a_blocks, b_blocks, table)
    n_inst, rows, la = a_blocks.shape
    return a_blocks.new_empty((n_inst, rows, la + b_blocks.shape[-1]),
                              dtype=L.LIMB_DTYPE)
