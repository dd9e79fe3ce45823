"""Bank execution engine: run ``planner.Plan`` objects as real multipliers.

Counterpart of the reference's ``core/bank/engine.py``.  A batch of
multiplications is dispatched across the plan's instances by a
pluggable :mod:`.schedule` policy, as the paper's Sec. V-E use case
issues work to the silicon bank.  The engine is

  * bit-exact: every instance runs its registered :mod:`.backends`
    multiplier, so the reassembled batch equals the Python-int oracle;
  * cycle-accounted: the dispatch schedule is simulated once per batch
    size, giving per-instance busy cycles and the bank makespan, and the
    report is kept per batch size;
  * static per batch size: on "fused" dispatch is one launch over the
    batch's rows with an owner table, on "kernel" gathers, a launch an
    instance and a scatter back, with the index tensors built once on
    the bank's device.
"""
from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from time import perf_counter

import torch

from .. import limbs as L
from ..mcim import MCIMConfig
from ..planner import Plan
from .backends import CAPABILITIES, cached_mul, get_backend
from .schedule import (completion_cycles, get_scheduler,
                       histogram_percentile, latency_histogram)
from repro_torch import telemetry
from repro_torch.device import resolve_device
from repro_torch.kernels.bank_fold import make_fused_dispatch


# ------------------------------------------------------------------ reports

@dataclasses.dataclass(frozen=True)
class InstanceReport:
    """Per-instance cycle accounting for one executed batch."""
    config: MCIMConfig
    n_ops: int
    busy_cycles: int          # n_ops * ct: cycles the datapath is occupied

    @property
    def ct(self) -> int:
        return self.config.ct


@dataclasses.dataclass(frozen=True)
class BankReport:
    """Throughput accounting for one executed batch."""
    batch: int
    cycles: int                       # bank makespan
    instances: tuple                  # tuple[InstanceReport]
    plan_throughput: Fraction
    working_set_bytes: int            # the reference's working-set figure
    scheduler: str = "round_robin"    # policy that produced the makespan
    #: per-request latency histogram, sorted ((cycles, count), ...)
    latency_hist: tuple = ()
    # filled in by CompiledDesign.report()
    energy_per_op_pj: float | None = None
    peak_power_mw: float | None = None

    @property
    def measured_throughput(self) -> Fraction:
        return Fraction(self.batch, self.cycles) if self.cycles else Fraction(0)

    @property
    def utilization(self) -> float:
        if not self.cycles:
            return 0.0
        return float(self.measured_throughput / self.plan_throughput)

    @property
    def energy_pj(self) -> float | None:
        """Total modeled switching energy of the batch."""
        if self.energy_per_op_pj is None:
            return None
        return self.batch * self.energy_per_op_pj

    def latency_percentile(self, q: float):
        return histogram_percentile(self.latency_hist, q)

    @property
    def latency_p50(self):
        return self.latency_percentile(0.50)

    @property
    def latency_p99(self):
        return self.latency_percentile(0.99)


# ------------------------------------------------------------------ the bank

class Bank:
    """Executable multiplier bank for one ``planner.Plan``.

    ``execute(a, b)`` multiplies int32 limb tensors (B, LA) x (B, LB) ->
    (B, LA+LB) bit-exactly on the bank's ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``).  ``backend`` picks the instance
    substrate ("core" | "kernel" | "fused"), ``scheduler`` the dispatch
    policy.  On "fused" a round is ONE ``bank_fold`` kernel launch; on
    "kernel" one ``mcim_fold`` launch per busy instance
    (:meth:`launch_count`).
    """

    # each distinct batch size builds its own dispatch and report; bound
    # both sets (FIFO eviction) so ragged batches cannot grow them
    # unboundedly
    MAX_COMPILED = 32

    def __init__(self, plan: Plan, bits_a: int, bits_b: int, *,
                 backend: str = "core", scheduler="round_robin",
                 tile_b: int = 256, device=None):
        if backend not in CAPABILITIES:
            raise ValueError(f"backend must be one of {CAPABILITIES}")
        self.device = resolve_device(device)
        self.plan = plan
        self.bits_a, self.bits_b = bits_a, bits_b
        self.la = L.n_limbs_for_bits(bits_a)
        self.lb = L.n_limbs_for_bits(bits_b)
        self.backend = backend
        self.scheduler = get_scheduler(scheduler)
        self.tile_b = tile_b
        # [(count, cfg)] -> flat instance list, Stars first
        self.instances = tuple(
            cfg for count, cfg in plan.configs for _ in range(count))
        if not self.instances:
            raise ValueError("plan has no instances")
        self._cts = tuple(cfg.ct for cfg in self.instances)
        self._backends = tuple(get_backend(cfg.arch, backend)
                               for cfg in self.instances)
        self._muls = tuple(cached_mul(cfg.arch, backend, cfg,
                                      self.la, self.lb)
                           for cfg in self.instances)
        signedness = {cfg.signed for cfg in self.instances}
        if backend == "fused" and len(signedness) > 1:
            raise ValueError(
                "fused backend needs uniform signedness across instances "
                "(the correction pass is applied bank-wide)")
        self._signed = self.instances[0].signed
        self._compiled = {}           # batch size -> dispatch closure
        self._reports = {}            # batch size -> BankReport
        self.last_report = None

    # -------------------------------------------------------------- reports
    def report(self, batch: int, scheduler=None) -> BankReport:
        """Cycle accounting for one batch; ``scheduler`` overrides the
        bank's policy for this report only.

        A schedule is static per batch size (:mod:`.schedule`), so the
        report under the bank's own policy is built once per size and the
        same frozen object returned after; the last ``MAX_COMPILED`` sizes
        are kept (FIFO).  A kept report holds its latency histogram, one
        ``(cycles, count)`` pair a distinct latency: at 2**20 ops about
        27 MiB of Python tuples on ``tp3p5_w32`` and 77 MiB on
        ``tp5over6_w128``.  A report under an explicit ``scheduler`` is
        built afresh and not kept.
        """
        if scheduler is not None:
            return self._build_report(batch, get_scheduler(scheduler))
        rep = self._reports.get(batch)
        if rep is None:
            if len(self._reports) >= self.MAX_COMPILED:
                self._reports.pop(next(iter(self._reports)))
            rep = self._reports[batch] = self._build_report(batch,
                                                            self.scheduler)
            telemetry.count("bank.report_builds")
        return rep

    def _build_report(self, batch: int, sched) -> BankReport:
        t0 = perf_counter()
        assign, cycles = sched.schedule(self._cts, batch)
        telemetry.span("bank.schedule", perf_counter() - t0)
        insts = tuple(
            InstanceReport(cfg, len(ops), len(ops) * cfg.ct)
            for cfg, ops in zip(self.instances, assign))
        arrivals = sched.arrivals_for(batch) \
            if hasattr(sched, "arrivals_for") else (0,) * batch
        t0 = perf_counter()
        finish = completion_cycles(self._cts, assign, arrivals)
        hist = latency_histogram(f - a for f, a in zip(finish, arrivals))
        telemetry.span("bank.latency", perf_counter() - t0)
        footprints = tuple(
            be.working_set(cfg, self.la, self.lb, self.tile_b)
            for cfg, be in zip(self.instances, self._backends))
        # fused instances time-share ONE datapath: the largest, not the sum
        ws = max(footprints) if self.backend == "fused" else sum(footprints)
        return BankReport(batch=batch, cycles=cycles, instances=insts,
                          plan_throughput=self.plan.throughput,
                          working_set_bytes=ws,
                          scheduler=sched.name,
                          latency_hist=hist)

    # -------------------------------------------------------------- execute
    def dispatch_fn(self, batch: int):
        """The dispatch closure ``run(a, b)`` for one batch size."""
        assign, _ = self.scheduler.schedule(self._cts, batch)
        if self.backend == "fused":
            return make_fused_dispatch(assign, self.instances,
                                       self.la, self.lb, batch,
                                       signed=self._signed,
                                       device=self.device)
        work = [(torch.tensor(ops, dtype=torch.int64, device=self.device),
                 mul) for ops, mul in zip(assign, self._muls) if ops]
        width = self.la + self.lb
        device = self.device

        def run(a, b):
            out = torch.zeros((batch, width), dtype=L.LIMB_DTYPE,
                              device=device)
            for idx, mul in work:
                out[idx] = mul(a[idx], b[idx])
            return out

        return run

    def launch_count(self, batch: int) -> int:
        """Hand-written kernel launches one bank round issues for this
        batch size: 1 on "fused", one per busy instance on "kernel", 0 on
        the plain PyTorch "core" path and for an empty round."""
        if self.backend == "core" or batch == 0:
            return 0
        if self.backend == "fused":
            return 1
        assign, _ = self.scheduler.schedule(self._cts, batch)
        return sum(1 for ops in assign if ops)

    def _check_operands(self, a, b) -> None:
        for name, x in (("a", a), ("b", b)):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"operand {name} must be a torch.Tensor of "
                                f"int32 limbs, got {type(x).__name__}")
            if x.device != self.device:
                raise ValueError(f"operand {name} is on {x.device}, the bank "
                                 f"runs on {self.device}")
            if x.dtype != L.LIMB_DTYPE:
                raise ValueError(f"operand {name} must be int32 limbs, "
                                 f"got {x.dtype}")

    def execute(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, LA) x (B, LB) -> (B, LA+LB) int32 limbs, bit-exact."""
        self._check_operands(a, b)
        if a.ndim == 1:
            return self.execute(a[None], b[None])[0]
        batch = a.shape[0]
        if b.shape[0] != batch:
            # without this, dispatch would index rows that do not exist
            raise ValueError(
                f"batch mismatch: a has {batch} ops, b has {b.shape[0]}")
        if a.shape[-1] != self.la or b.shape[-1] != self.lb:
            raise ValueError(
                f"operand limbs {a.shape[-1]}x{b.shape[-1]} do not match "
                f"bank widths {self.la}x{self.lb}")
        fn = self._compiled.get(batch)
        if fn is None:
            if len(self._compiled) >= self.MAX_COMPILED:
                self._compiled.pop(next(iter(self._compiled)))
            t0 = perf_counter()
            fn = self._compiled[batch] = self.dispatch_fn(batch)
            telemetry.span("bank.dispatch_build", perf_counter() - t0)
            telemetry.count("bank.dispatch_builds")
        self.last_report = self.report(batch)
        return fn(a, b)

    def describe(self) -> str:
        return (f"Bank[{self.plan.describe()}  backend={self.backend}  "
                f"scheduler={self.scheduler.name}  "
                f"{len(self.instances)} instances  device={self.device}]")


# ------------------------------------------------------------------ module API

@functools.lru_cache(maxsize=64)
def _bank_for(plan: Plan, bits_a: int, bits_b: int, backend: str,
              scheduler: str, device: torch.device) -> Bank:
    return Bank(plan, bits_a, bits_b, backend=backend, scheduler=scheduler,
                device=device)


def _operand_bank(plan: Plan, a, b, backend: str, scheduler: str) -> Bank:
    """The cached bank for the operands' limb counts, on their device."""
    la = a.shape[-1] if a.ndim > 1 else a.shape[0]
    lb = b.shape[-1] if b.ndim > 1 else b.shape[0]
    return _bank_for(plan, la * L.RADIX_BITS, lb * L.RADIX_BITS, backend,
                     scheduler, a.device)


def execute(plan: Plan, a: torch.Tensor, b: torch.Tensor, *,
            backend: str = "core",
            scheduler: str = "round_robin") -> torch.Tensor:
    """One-shot bank execution: dispatch a batch across ``plan``'s
    instances and return the (B, LA+LB) int32 limb products.

    Operand bit widths are taken from the limb counts, and the bank runs
    on the operands' device.  Banks are cached per (plan, widths,
    backend, scheduler, device), so repeated calls re-use the dispatch.
    Use ``last_report(plan, a, b)`` -- or a ``Bank`` object directly --
    for the cycle accounting.
    """
    return _operand_bank(plan, a, b, backend, scheduler).execute(a, b)


def last_report(plan: Plan, a: torch.Tensor, b: torch.Tensor, *,
                backend: str = "core",
                scheduler: str = "round_robin") -> BankReport:
    """Cycle-accounting report for the batch shape of (a, b)."""
    batch = a.shape[0] if a.ndim > 1 else 1
    return _operand_bank(plan, a, b, backend, scheduler).report(batch)
