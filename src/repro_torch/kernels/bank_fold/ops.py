"""Dispatch glue: one plan round -> one fused kernel launch.

Counterpart of the reference's ``kernels/bank_fold/ops.py``.
:func:`make_fused_dispatch` turns a scheduler assignment (which ops run
on which instance) into a closure ``run(a, b) -> products`` that

  1. gathers each instance's assigned operand rows into a padded
     ``(N_INST, R, L)`` block (index tensors built once, on the device),
  2. runs :func:`.kernel.fused_bank_mul` ONCE for the whole round,
  3. gathers the valid product rows back into batch order, and
  4. for signed designs, applies the shared two's-complement correction
     (:func:`repro_torch.core.mcim.signed_correction`) as torch ops, so
     the round still costs one kernel launch.

Padding rows re-gather op 0's operands; their products are computed and
never read back, so they cannot overwrite op 0's product.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mcim import signed_correction
from repro_torch.kernels.mcim_fold import batch_tile
from .geometry import super_geometry
from .kernel import fused_bank_mul


def fused_block_rows(assign) -> tuple:
    """(rows, tile_r) of the padded per-instance op blocks: the largest
    assignment padded up to a :func:`batch_tile` multiple, as in the
    reference (the CUDA kernel masks the row edge itself and needs no
    tile; the padding keeps the reference's block shapes)."""
    max_ops = max((len(ops) for ops in assign), default=0)
    max_ops = max(max_ops, 1)         # degenerate all-empty round
    tile_r, pad = batch_tile(max_ops)
    return max_ops + pad, tile_r


def make_fused_dispatch(assign, configs, la: int, lb: int, batch: int, *,
                        signed: bool = False, device=None):
    """Build the one-launch dispatch closure for one (schedule, batch).

    ``assign`` is the scheduler's static assignment (tuple per instance
    of op indices into the batch, every op exactly once), ``configs`` the
    flat instance list aligned with it.  The closure maps ``(B, LA) x
    (B, LB) -> (B, LA+LB)`` int32 limbs on ``device``.
    """
    sg = super_geometry(configs, la, lb)
    n_inst = sg.n_instances
    if len(assign) != n_inst:
        raise ValueError(
            f"assignment covers {len(assign)} instances, plan has {n_inst}")
    rows, _ = fused_block_rows(assign)

    # padded rows re-fetch op 0 (computed, never read back)
    gather = np.zeros((n_inst, rows), np.int64)
    source = np.zeros((batch,), np.int64)      # op -> flat (instance, row)
    for i, ops in enumerate(assign):
        for r, op in enumerate(ops):
            gather[i, r] = op
            source[op] = i * rows + r
    gather = torch.from_numpy(gather).to(device)
    source = torch.from_numpy(source).to(device)
    table = torch.from_numpy(sg.table()).to(device)

    def run(a, b):
        prod = fused_bank_mul(a[gather], b[gather], table)
        out = prod.reshape(n_inst * rows, la + lb)[source]
        if signed:
            out = signed_correction(a, b, out)
        return out

    return run
