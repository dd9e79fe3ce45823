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
:func:`fused_dispatch_maps` builds the gather and read-back maps as
numpy, so the dispatch and the plan-time gate
(:func:`launch_contract`, :mod:`repro_torch.verify.dataflow`) share one
construction.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mcim import signed_correction
from repro_torch.kernels.mcim_fold import batch_tile
from .geometry import super_geometry
from .kernel import fused_bank_mul, launch_plan


def fused_block_rows(assign) -> tuple:
    """(rows, tile_r) of the padded per-instance op blocks: the largest
    assignment padded up to a :func:`batch_tile` multiple, as in the
    reference (the CUDA kernel masks the row edge itself and needs no
    tile; the padding keeps the reference's block shapes)."""
    max_ops = max((len(ops) for ops in assign), default=0)
    max_ops = max(max_ops, 1)         # degenerate all-empty round
    tile_r, pad = batch_tile(max_ops)
    return max_ops + pad, tile_r


def fused_dispatch_maps(assign, rows: int, batch: int) -> tuple:
    """(gather, source) of one round as int64 numpy arrays: ``gather[i,
    r]`` is the op whose operands row r of instance i's block takes
    (padding rows take op 0), ``source[op]`` the flat (instance, row)
    index ``i * rows + r`` its product is read back from."""
    gather = np.zeros((len(assign), rows), np.int64)
    source = np.zeros((batch,), np.int64)
    for i, ops in enumerate(assign):
        ops = np.asarray(ops, np.int64)
        gather[i, :len(ops)] = ops
        source[ops] = i * rows + np.arange(len(ops))
    return gather, source


def launch_contract(configs, la: int, lb: int, rows: int = 64,
                    tile_r: int = None, table=None, *, assign=None):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    Declares the one fused launch of a bank round over ``configs``: the
    path :func:`.kernel.launch_plan` takes for the round's padded blocks
    (aligned, as the gathers allocate them), its grid, threads and
    shared memory on the H100, the concrete window table with the idle
    steps the super-geometry pads, and the dispatch's gather and source
    maps.  ``assign`` is the round's scheduler assignment; by default
    the ``round_robin`` assignment of ``rows`` ops (the reference's
    hook takes ``rows`` as the block's rows; its ``tile_r``, the TPU
    row tile, is kept in ``meta`` and pads nothing here).

    ``table`` overrides the super-geometry's schedule table; the
    override flows into the declaration, so a corrupted table is
    analyzed exactly like a shipped one.
    """
    from repro_torch.core.bank.schedule import round_robin_schedule
    from repro_torch.kernels import introspect
    sg = super_geometry(configs, la, lb)
    n_inst = sg.n_instances
    if assign is None:
        assign, _ = round_robin_schedule(
            tuple(cfg.ct for cfg in sg.configs), rows)
    block_rows, tile = fused_block_rows(assign)
    batch = sum(len(ops) for ops in assign)
    gather, source = fused_dispatch_maps(assign, block_rows, batch)
    table = np.asarray(sg.table() if table is None else table, np.int32)
    max_steps = table.shape[1] if table.ndim == 3 else sg.max_steps
    path = launch_plan(n_inst, block_rows, la, lb, True)
    idle = tuple((i, j) for i, geo in enumerate(sg.rows)
                 for j in range(geo.ct_run, sg.max_steps))
    ops = block_rows * sum(
        introspect.ops_per_row("bank_fold", la, lb, sg.windows(i))
        for i in range(n_inst))
    kernel = ("bank_fold_bulk_launch" if path == "bulk"
              else "bank_fold_launch")
    return introspect.row_tile_contract(
        name=(f"bank_fold[la={la},lb={lb},n={n_inst},steps={sg.max_steps},"
              f"rows={block_rows}]"),
        lib="bank_fold", kernel=kernel, path=path,
        n_inst=n_inst, rows=block_rows, la=la, lb=lb,
        launch_args=(n_inst, block_rows, la, lb, max_steps),
        operands={
            "a": introspect.Operand((n_inst, block_rows, la), "int32"),
            "b": introspect.Operand((n_inst, block_rows, lb), "int32"),
            "table": introspect.Operand(tuple(table.shape), "int32")},
        out_shape=(n_inst, block_rows, la + lb), ops=ops,
        table=table, idle_steps=idle, super_geometry=sg,
        gather=gather, source=source,
        n_ops=tuple(len(ops) for ops in assign), batch=batch,
        tile_r=tile if tile_r is None else tile_r,
        roofline_skip=("table",))


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
    if batch == 0:
        # an empty round: no op 0 to pad with, and nothing to launch
        def run(a, b):
            return torch.empty((0, la + lb), dtype=torch.int32,
                               device=a.device)
        return run
    rows, _ = fused_block_rows(assign)
    # padded rows re-fetch op 0 (computed, never read back)
    gather, source = fused_dispatch_maps(assign, rows, batch)
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
