"""Fused bank round in one launch: the CUDA kernel and its plain version.

Counterpart of the reference's ``kernels/bank_fold/kernel.py``, whose
TPU kernel ``_bank_kernel`` is hand-written CUDA in
``csrc/bank_fold.cu`` here.  The reference multiplies each instance's
block of gathered rows; here a launch takes the round's rows in batch
order, ``(B, LA) x (B, LB) -> (B, LA+LB)``, with an ``owner`` table
naming the instance that computes each row, so nothing is gathered
around it.  Two paths: TMA bulk copies of row tiles on a persistent
grid, and a coalesced per-thread path for what a bulk copy cannot take.
:func:`launch_plan` picks the path from the shape, the alignment and the
instance count alone; :func:`fused_bank_rows` launches it for CUDA
tensors and runs :func:`fused_bank_mul_ref`, a windowed schoolbook on
int64 lanes, for CPU tensors; nothing else selects between them.
:func:`fused_bank_mul` takes the reference's per-instance blocks.  The
launch is the custom op ``repro_torch::fused_bank_mul_kernel``, whose
fake version gives the product's shape from the operands' alone (fake
tensors see through it: ``verify.contracts.check_bank_static``).
"""
from __future__ import annotations

import torch

from repro_torch.core import limbs as L
from repro_torch.kernels import _build, _row_tiles
from repro_torch.kernels._row_tiles import PATHS


def _check_shapes(a, b, owner, table) -> None:
    if a.ndim != 2 or b.ndim != 2 or owner.ndim != 1 or table.ndim != 3:
        raise ValueError("expected (B, LA) x (B, LB) rows, a (B,) owner "
                         "table and an (N_INST, max_steps, 2) schedule "
                         "table")
    if b.shape[0] != a.shape[0] or owner.shape[0] != a.shape[0]:
        raise ValueError(f"rows {tuple(a.shape)} x {tuple(b.shape)} and "
                         f"owners {tuple(owner.shape)} do not match")
    if table.shape[0] < 1 or table.shape[2] != 2:
        raise ValueError(f"schedule table {tuple(table.shape)} is not "
                         f"(N_INST, max_steps, 2)")


def fused_bank_mul_ref(a: torch.Tensor, b: torch.Tensor,
                       owner: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version: row k is multiplied by instance ``owner[k]``: for
    each step j, B masked to the window ``table[owner[k], j] = (lo,
    hi)``; the masked partial products are accumulated as int64 column
    sums; one carry pass at the end.  Returns (B, LA+LB) int32 limbs."""
    _check_shapes(a, b, owner, table)
    la, lb = a.shape[-1], b.shape[-1]
    a64 = a.to(L.COL_DTYPE)
    b64 = b.to(L.COL_DTYPE)
    windows = table.to(a.device)[owner.to(a.device).long()]  # (B, steps, 2)
    limb = torch.arange(lb, device=a.device)
    acc = torch.zeros((a.shape[0], la + lb), dtype=L.COL_DTYPE,
                      device=a.device)
    for j in range(table.shape[1]):
        lo, hi = windows[:, j, 0:1], windows[:, j, 1:2]    # (B, 1)
        bm = b64 * ((limb >= lo) & (limb < hi))             # window mask
        for jj in range(lb):
            p = a64 * bm[:, jj:jj + 1]                      # exact 16x16
            acc[:, jj:jj + la] += p & L.MASK
            acc[:, jj + 1:jj + la + 1] += p >> L.RADIX_BITS
    return L.final_adder_1ca(acc, la + lb)


def launch_plan(n_inst: int, rows: int, la: int, lb: int,
                aligned: bool) -> str:
    """The path of ``csrc/bank_fold.cu`` (one of :data:`PATHS`) that
    takes a round of ``rows`` (LA, LB) rows over ``n_inst`` instances:
    ``"bulk"`` where TMA bulk copies can move every tile (LA = LB in 2,
    4, 8, 16, 24; 16-byte-aligned operands, ``aligned``; R * LA a
    multiple of 4) and a block's shared memory holds every instance's
    limb weights (at most :data:`~._row_tiles.BULK_INSTANCES`), else
    ``"per_thread"``.  See :mod:`repro_torch.kernels._row_tiles`."""
    if n_inst > _row_tiles.BULK_INSTANCES:
        return "per_thread"
    return _row_tiles.plan(rows, la, lb, aligned)


def fused_bank_rows(a: torch.Tensor, b: torch.Tensor, owner: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """One launch: (B, LA) x (B, LB) -> (B, LA+LB), row k multiplied by
    instance ``owner[k]`` (int32).

    ``table`` is the (N_INST, max_steps, 2) int32 schedule table of
    :meth:`.geometry.SuperGeometry.table`.  Rows are independent
    multiplications, in the caller's order.  Every owner must lie in
    [0, N_INST): the kernel indexes the table by it unchecked
    (:func:`.ops.fused_owner` builds such a table from an assignment, and
    the plan-time gate holds it to the assignment).
    """
    if all(t.device.type == "cpu" for t in (a, b, owner, table)):
        return fused_bank_mul_ref(a, b, owner, table)
    return fused_bank_mul_kernel(a, b, owner, table, path="auto")


def fused_bank_mul(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """The reference's form: (N_INST, R, LA) x (N_INST, R, LB) blocks ->
    (N_INST, R, LA+LB), block i computed by instance i; one
    :func:`fused_bank_rows` launch over the blocks' rows."""
    if a_blocks.ndim != 3 or b_blocks.ndim != 3 or table.ndim != 3:
        raise ValueError("expected (N_INST, R, LA) x (N_INST, R, LB) "
                         "blocks and an (N_INST, max_steps, 2) table")
    n_inst, rows, la = a_blocks.shape
    if b_blocks.shape[:2] != (n_inst, rows) or table.shape[0] != n_inst:
        raise ValueError(f"blocks {tuple(a_blocks.shape)} x "
                         f"{tuple(b_blocks.shape)} and table "
                         f"{tuple(table.shape)} do not match")
    owner = torch.arange(n_inst, dtype=torch.int32,
                         device=a_blocks.device).repeat_interleave(rows)
    out = fused_bank_rows(a_blocks.reshape(n_inst * rows, la),
                          b_blocks.reshape(n_inst * rows, -1), owner, table)
    return out.reshape(n_inst, rows, -1)


# One launch of the path ``path`` (one of :data:`PATHS`, or "auto":
# :func:`launch_plan`'s choice) on CUDA tensors.  :func:`fused_bank_rows`
# passes "auto"; naming a path lets the card compare the paths on one
# shape.  The bulk path raises on rows only the per-thread path takes.
@torch.library.custom_op("repro_torch::fused_bank_mul_kernel",
                         mutates_args=())
def fused_bank_mul_kernel(a: torch.Tensor, b: torch.Tensor,
                          owner: torch.Tensor, table: torch.Tensor, *,
                          path: str) -> torch.Tensor:
    _check_shapes(a, b, owner, table)
    (rows, la), lb = a.shape, b.shape[-1]
    n_inst, max_steps = table.shape[0], table.shape[1]
    planned = launch_plan(n_inst, rows, la, lb,
                          _row_tiles.is_aligned(a, b))
    if path == "auto":
        path = planned
    if path not in PATHS:
        raise ValueError(f"bank_fold: path must be one of {PATHS}, "
                         f"got {path!r}")
    if path == "bulk" and planned != "bulk":
        if n_inst > _row_tiles.BULK_INSTANCES:
            raise ValueError(
                f"bank_fold: a round of {n_inst} instances; a bulk block "
                f"keeps the limb weights of at most "
                f"{_row_tiles.BULK_INSTANCES} in shared memory beside "
                f"tiles::Bulk<{la}>'s buffers, so the bulk path does not "
                f"take it")
        raise ValueError(f"bank_fold: {tuple(a.shape)} x {tuple(b.shape)} "
                         f"rows are not bulk copies' spans; the bulk path "
                         f"does not take them")
    _build.check_cuda_operands("bank_fold", a, b, owner, table)
    _build.check_limbs("bank_fold", la, lb)
    out = torch.empty((rows, la + lb), dtype=L.LIMB_DTYPE, device=a.device)
    if out.numel() == 0:
        return out
    symbol = "bank_fold_bulk_launch" if path == "bulk" else "bank_fold_launch"
    fn = _build.launcher("bank_fold", symbol, 5, 5)
    _build.launch("bank_fold", fn, (a, b, owner, table, out),
                  (n_inst, rows, la, lb, max_steps), path=path,
                  limbs=max(la, lb))
    return out


@fused_bank_mul_kernel.register_fake
def _(a, b, owner, table, *, path):
    _check_shapes(a, b, owner, table)
    return a.new_empty((a.shape[0], a.shape[1] + b.shape[-1]),
                       dtype=L.LIMB_DTYPE)
