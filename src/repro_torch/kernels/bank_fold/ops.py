"""Dispatch glue: one plan round -> one fused kernel launch.

Counterpart of the reference's ``kernels/bank_fold/ops.py``.
:func:`make_fused_dispatch` turns a scheduler assignment (which ops run
on which instance) into a closure ``run(a, b) -> products`` that

  1. runs :func:`.kernel.fused_bank_rows` ONCE for the whole round, on
     the caller's rows in batch order, with an owner table (built once,
     on the device) naming the instance that computes each row, and
  2. for signed designs, applies the shared two's-complement correction
     (:func:`repro_torch.core.mcim.signed_correction`) as torch ops, so
     the round still costs one kernel launch.

The reference gathers each instance's operand rows into a padded block
and its products back into batch order; every instance computes the
exact product, its windows only weighting the schoolbook, so the port
computes each row where it lies, with its instance's windows, and moves
nothing around the launch.  :func:`fused_owner` builds the owner table
as numpy, so the dispatch and the plan-time gate
(:func:`launch_contract`, :mod:`repro_torch.verify.dataflow`) share one
construction.
"""
from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.mcim import signed_correction
from repro_torch.kernels.mcim_fold import batch_tile
from .geometry import super_geometry
from .kernel import fused_bank_rows, launch_plan


def fused_block_rows(assign) -> tuple:
    """(rows, tile_r) of the reference's padded per-instance op blocks:
    the largest assignment padded up to a :func:`batch_tile` multiple
    (the port's launch takes the round's rows in batch order and pads
    nothing)."""
    max_ops = max((len(ops) for ops in assign), default=0)
    max_ops = max(max_ops, 1)         # degenerate all-empty round
    tile_r, pad = batch_tile(max_ops)
    return max_ops + pad, tile_r


def fused_owner(assign, batch: int) -> np.ndarray:
    """The round's owner table, ``(batch,)`` int32: ``owner[op] = i`` for
    every op of ``assign[i]`` (-1 for an op no instance was assigned,
    which the plan-time gate refuses)."""
    owner = np.full((batch,), -1, np.int32)
    for i, ops in enumerate(assign):
        owner[np.asarray(ops, np.int64)] = i
    return owner


def launch_contract(configs, la: int, lb: int, rows: int = 64,
                    tile_r: int = None, table=None, *, assign=None):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    Declares the one fused launch of a bank round over ``configs``: the
    path :func:`.kernel.launch_plan` takes for the round's rows (aligned,
    as the bank's operands and the launch's output are), its grid,
    threads and shared memory on the H100, the operands ``a``, ``b``,
    ``owner`` and ``table`` and the ``(B, LA+LB)`` output, the concrete
    window table with the idle steps the super-geometry pads, the owner
    table and the assignment it is held to.  ``assign`` is the round's
    scheduler assignment; by default the ``round_robin`` assignment of
    ``rows`` ops (the reference's hook takes ``rows`` as the block's
    rows; its ``tile_r``, the TPU row tile, pads nothing here and is
    kept in ``meta`` as given).  The operations are each instance's
    per-row count over its real rows.

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
    n_ops = tuple(len(ops) for ops in assign)
    batch = sum(n_ops)
    table = np.asarray(sg.table() if table is None else table, np.int32)
    max_steps = table.shape[1] if table.ndim == 3 else sg.max_steps
    path = launch_plan(n_inst, batch, la, lb, True)
    idle = tuple((i, j) for i, geo in enumerate(sg.rows)
                 for j in range(geo.ct_run, sg.max_steps))
    ops = sum(n * introspect.ops_per_row("bank_fold", la, lb, sg.windows(i))
              for i, n in enumerate(n_ops))
    kernel = ("bank_fold_bulk_launch" if path == "bulk"
              else "bank_fold_launch")
    return introspect.row_tile_contract(
        name=(f"bank_fold[la={la},lb={lb},n={n_inst},steps={sg.max_steps},"
              f"batch={batch}]"),
        lib="bank_fold", kernel=kernel, path=path, rows=batch, la=la, lb=lb,
        launch_args=(n_inst, batch, la, lb, max_steps),
        operands={
            "a": introspect.Operand((batch, la), "int32"),
            "b": introspect.Operand((batch, lb), "int32"),
            "owner": introspect.Operand((batch,), "int32"),
            "table": introspect.Operand(tuple(table.shape), "int32")},
        out_shape=(batch, la + lb), ops=ops,
        table=table, idle_steps=idle, super_geometry=sg,
        owner=fused_owner(assign, batch), assign=assign, n_ops=n_ops,
        batch=batch, n_instances=n_inst,
        tile_r=tile_r,
        roofline_skip=("table",))


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the launch takes it; a copy where it is not contiguous,
    counted as ``bank_fold.operand_copies``."""
    if x.is_contiguous():
        return x
    telemetry.count("bank_fold.operand_copies")
    return x.contiguous()


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
        # an empty round: nothing to launch
        def run(a, b):
            return torch.empty((0, la + lb), dtype=torch.int32,
                               device=a.device)
        return run
    owner = torch.from_numpy(fused_owner(assign, batch)).to(device)
    table = torch.from_numpy(sg.table()).to(device)

    def run(a, b):
        a, b = _contiguous(a), _contiguous(b)
        t0 = perf_counter()
        out = fused_bank_rows(a, b, owner, table)
        telemetry.span("bank_fold.launch", perf_counter() - t0)
        if signed:
            out = signed_correction(a, b, out)
        return out

    return run
