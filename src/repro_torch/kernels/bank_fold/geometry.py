"""Fused-bank super-geometry: one shape contract for a whole plan.

A copy of the reference's ``kernels/bank_fold/geometry.py``.  A
``planner.Plan`` is a *bank* of folded multiplier instances.  The
per-instance path launches one kernel per instance; the fused kernel
(:mod:`.kernel`) instead runs the whole bank round in one launch over
``(instance, step)``.  This module owns the static shape contract of
that flattening, the way
:func:`repro_torch.kernels.mcim_fold.fold_geometry` owns the per-instance
contracts.

The fused datapath is a *windowed schoolbook fold*: grid step ``j`` of
instance ``i`` masks the B operand to the limb window ``table[i, j]``
and accumulates ``ppm(A, B & window)`` carry-save columns into a
full-width accumulator (the B limbs sit at their absolute positions, so
no per-step shift is needed; the final carry pass runs once, on the
last grid step).  Each instance's window sequence is its
``fold_geometry`` row re-expressed for the shared datapath:

  star       1 window covering all of B         (CT = 1)
  fb / ff    CT windows of ceil(LB/CT) limbs    (the paper's fold)
  karatsuba  3 windows (its CT=3 temporal fold time-shares the fused
             datapath the same way it time-shares the silicon PPM)

Heterogeneous CTs meet in one launch by *masking idle grid steps*: the
super-geometry pads every instance to ``max_steps`` rows and assigns
idle steps the empty window ``(0, 0)``, which masks the whole B operand
to zero -- the step is architecturally a no-op, matching the silicon
bank where a short-CT instance idles while a long-CT neighbour drains.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mcim import MCIMConfig
from repro_torch.kernels.mcim_fold import FoldGeometry

#: schedule tag of every fused per-instance geometry row
FUSED_SCHEDULE = "fused"


def fused_ct(cfg: MCIMConfig) -> int:
    """Grid steps the fused datapath folds one instance over (its CT)."""
    if cfg.arch == "star":
        return 1
    if cfg.arch == "karatsuba":
        return 3
    return cfg.ct


def fused_geometry(cfg: MCIMConfig, la: int, lb: int) -> FoldGeometry:
    """One instance's row of the fused super-geometry.

    ``chunk``/``ct_run`` describe the instance's B-limb windows on the
    shared datapath; ``scratch_width``/``out_width`` are the full-width
    carry-save accumulator and retired product (every instance shares
    the same accumulator block, so both are ``LA + LB`` regardless of
    arch -- the fused analogue of the FF register file).
    """
    ct = fused_ct(cfg)
    chunk = -(-lb // ct)
    ct_run = -(-lb // chunk)          # CT > LB: trailing steps are idle
    return FoldGeometry(schedule=FUSED_SCHEDULE, la=la, lb=lb,
                        chunk=chunk, ct_run=ct_run,
                        scratch_width=la + lb, out_width=la + lb)


def fused_windows(cfg: MCIMConfig, la: int, lb: int) -> tuple:
    """Per-step (lo, hi) B-limb windows, clipped to the real LB limbs."""
    geo = fused_geometry(cfg, la, lb)
    return tuple((lo, min(hi, lb)) for lo, hi in geo.b_windows)


@dataclasses.dataclass(frozen=True)
class SuperGeometry:
    """Static contract of one fused bank launch.

    ``rows[i]`` is instance i's :func:`fused_geometry`; every row is
    padded to ``max_steps`` grid steps.  ``table()`` materializes the
    per-instance schedule table the kernel reads from device memory:
    ``table[i, j] = (lo, hi)`` is the B-limb window of
    instance i's step j, ``(0, 0)`` marking masked idle steps.
    """
    la: int
    lb: int
    configs: tuple            # flat tuple[MCIMConfig], one per instance
    rows: tuple               # tuple[FoldGeometry], aligned with configs
    max_steps: int            # padded grid-step count (max ct_run)
    scratch_width: int        # shared carry-save accumulator columns
    out_width: int            # retired product limbs

    @property
    def n_instances(self) -> int:
        return len(self.rows)

    def windows(self, i: int) -> tuple:
        """Instance i's windows padded with idle (0, 0) steps."""
        wins = tuple((lo, min(hi, self.lb))
                     for lo, hi in self.rows[i].b_windows)
        return wins + ((0, 0),) * (self.max_steps - len(wins))

    def table(self) -> np.ndarray:
        """(n_instances, max_steps, 2) int32 schedule table."""
        tbl = np.zeros((self.n_instances, self.max_steps, 2), np.int32)
        for i in range(self.n_instances):
            for j, (lo, hi) in enumerate(self.windows(i)):
                tbl[i, j] = (lo, hi)
        return tbl


def super_geometry(configs, la: int, lb: int) -> SuperGeometry:
    """Fused super-geometry of a flat instance list.

    Raises ``ValueError`` for an empty bank -- a fused launch needs at
    least one instance row.
    """
    configs = tuple(configs)
    if not configs:
        raise ValueError("fused bank needs at least one instance")
    rows = tuple(fused_geometry(cfg, la, lb) for cfg in configs)
    return SuperGeometry(
        la=la, lb=lb, configs=configs, rows=rows,
        max_steps=max(geo.ct_run for geo in rows),
        scratch_width=la + lb, out_width=la + lb)


def vmem_bytes_per_step(la: int, lb: int, tile_r: int,
                        n_instances: int = 1, max_steps: int = 1) -> int:
    """The reference's per-step working-set figure of the fused datapath,
    kept so ``BankReport.working_set_bytes`` matches it.

    It counts a ``tile_r``-row tile's A, B, accumulator and output words
    plus the schedule table; the instances time-share one datapath, so it
    does not scale with the instance count (the fused analogue of the
    paper's folded silicon area).  It is an area-model quantity, not a
    memory size of the TPU or of the H100 kernel.
    """
    words = tile_r * (la                    # A tile
                      + lb                  # B tile (masked per step)
                      + (la + lb)           # carry-save accumulator
                      + (la + lb))          # output tile
    return words * 4 + n_instances * max_steps * 2 * 4
