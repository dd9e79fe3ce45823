"""generate(): compile a DesignSpec into an executable CompiledDesign.

Counterpart of the reference's ``designs/compile.py``: the paper's
design generator as one function.  Candidate plans are filtered through
``core.timing_model`` (a relaxed plan whose feedback-loop instances
cannot meet ``spec.clock_ns`` falls back to pipelineable designs; a
latency budget rejects designs too deep at the target), and the
resulting ``CompiledDesign`` owns the chosen ``planner.Plan``, an
executable ``Bank`` on one device, and the area/latency/fmax/power
figures the paper's tables report.  A spec with ``replicas > 1``
replicates the bank over a list of devices (the reference's mesh axis;
:mod:`repro_torch.core.bank.sharded`), and its throughput, area and
peak power count every replica.

Every plan passes the static gates ``verify.assert_plan`` and then
``verify.assert_plan_dataflow`` (the CUDA launches the plan implies,
from the kernels' launch contracts) before a bank is built around it,
as in the reference.  ``CompiledDesign.serve`` runs the online serving
loop (:mod:`repro_torch.serving`).
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from repro_torch.core import limbs as L
from repro_torch.core import area_model, planner, power_model, timing_model
from repro_torch.core.bank import (Bank, BankReport, StreamingScheduler,
                                   sharded_execute)
from repro_torch.core.mcim import MCIMConfig
from repro_torch.device import resolve_device
from repro_torch import telemetry, verify

from .spec import DesignSpec, DesignError, TimingError, LatencyError


def _timing_bits(spec: DesignSpec) -> int:
    """Width driving the critical path (the wider operand dominates)."""
    return max(spec.bits_a, spec.bits_b)


def _timing_violations(plan: planner.Plan, bits: int,
                       clock_ns: float) -> list:
    return [cfg for _, cfg in plan.configs
            if not timing_model.meets_timing(cfg.arch, bits, clock_ns,
                                             cfg.adder)]


def _instance_latency(cfg: MCIMConfig, bits: int,
                      clock_ns: float | None) -> int:
    t = clock_ns if clock_ns is not None else math.inf
    return timing_model.latency_at(cfg.arch, bits, t, cfg.ct)


def _instance_period(cfg: MCIMConfig, bits: int,
                     clock_ns: float | None) -> float:
    """Achievable clock period of one instance: non-pipelineable ones are
    capped at their combinational path; pipelineable ones retime down to
    the target (paying latency)."""
    t = timing_model.t_comb(cfg.arch, bits)
    if clock_ns is not None and clock_ns < t and \
            timing_model.pipelineable(cfg.arch, cfg.adder):
        return clock_ns
    return t


class CompiledDesign:
    """An executable multiplier design compiled from a :class:`DesignSpec`.

    Owns the timing-filtered ``plan``, the executable ``bank`` (scheduler,
    backend and device resolved), the paper's area / latency / fmax /
    power figures as properties, and provenance (``spec`` / ``to_json``).
    ``mul(a, b)`` multiplies int32 limb tensors on the bank's device --
    or two Python ints -- bit-exactly.  With ``spec.replicas > 1``,
    ``devices`` holds one device a replica.
    """

    def __init__(self, spec: DesignSpec, plan: planner.Plan, bank: Bank,
                 devices=None, timing_fallback: bool = False):
        self.spec = spec
        self.plan = plan
        self.bank = bank
        self.devices = devices
        #: True when the relaxed plan missed spec.clock_ns and planning
        #: was redone with strict (pipelineable-only) candidates.
        self.timing_fallback = timing_fallback
        self.la = bank.la
        self.lb = bank.lb

    @property
    def device(self) -> torch.device:
        return self.bank.device

    # ------------------------------------------------------------ execute
    def mul(self, a, b):
        """Multiply: int32 limb tensors (B, LA) x (B, LB) -> (B, LA+LB), or
        two Python ints -> int (two's complement when the spec is signed).

        Routes limb batches to the replicated sharded engine when the
        spec asked for replicas (the products come back on the operands'
        device), else to the single bank (operands on another device
        than the bank's raise).  Each call is one ``design.mul`` row of
        :mod:`repro_torch.telemetry`.
        """
        with telemetry.root("design.mul"):
            if isinstance(a, (int, np.integer)) and \
                    isinstance(b, (int, np.integer)):
                return self._mul_ints(int(a), int(b))
            if self.devices is not None:
                return sharded_execute(self.plan, a, b, self.devices,
                                       backend=self.bank.backend,
                                       scheduler=self.spec.scheduler,
                                       axis=self.spec.mesh_axis)
            return self.bank.execute(a, b)

    def _mul_ints(self, a: int, b: int) -> int:
        enc_a = L.from_numpy(self._encode(a, self.spec.bits_a, self.la),
                             self.device)
        enc_b = L.from_numpy(self._encode(b, self.spec.bits_b, self.lb),
                             self.device)
        total = L.from_limbs(self.bank.execute(enc_a, enc_b))
        if self.spec.signed:
            width = L.RADIX_BITS * (self.la + self.lb)
            if total >= 1 << (width - 1):
                total -= 1 << width
        return total

    def _encode(self, v: int, bits: int, limbs: int) -> np.ndarray:
        if self.spec.signed:
            if not -(1 << (bits - 1)) <= v < (1 << (bits - 1)):
                raise ValueError(f"{v} out of signed {bits}-bit range")
            v %= 1 << (L.RADIX_BITS * limbs)
        elif not 0 <= v < (1 << bits):
            raise ValueError(f"{v} out of unsigned {bits}-bit range")
        return L.to_limbs(v, limbs)

    # ------------------------------------------------------------ reports
    def report(self, batch: int) -> BankReport:
        """Cycle accounting for one batch (per replica when sharded),
        with the design's modeled energy/op and peak power attached."""
        if self.spec.replicas > 1:
            if batch % self.spec.replicas:
                raise ValueError(f"batch {batch} does not divide over "
                                 f"{self.spec.replicas} replicas")
            batch //= self.spec.replicas
        return dataclasses.replace(self.bank.report(batch),
                                   energy_per_op_pj=self.energy_per_op_pj,
                                   peak_power_mw=self.peak_power_mw)

    def replay(self, arrivals) -> BankReport:
        """Replay an arrival trace through this design's bank under the
        streaming scheduler: one work item per trace entry, issued no
        earlier than its arrival cycle."""
        trace = tuple(int(c) for c in arrivals)
        sched = StreamingScheduler(arrivals=trace)
        return self.bank.report(len(trace), scheduler=sched)

    def serve(self, requests, *, replicas: int = 1,
              round_cycles: int | None = None, steal: bool = True,
              autoscaler=None, check: bool = False):
        """Serve a request stream *online* through this design.

        Where :meth:`replay` scores a finished arrival trace, ``serve``
        runs the full event loop of :class:`repro_torch.serving.Worker`:
        SLO admission control, EDF dispatch in bank rounds (one
        ``bank_fold`` launch per round on the fused backend), work
        stealing across ``replicas`` independent bank replicas on this
        design's device, and optional autoscaling (pass a
        ``repro_torch.serving.Autoscaler``).  ``check=True`` verifies
        every response against the Python-bigint oracle.

        Returns ``(report, responses)``: the
        :class:`~repro_torch.serving.ServingReport` and the per-request
        ``{rid: Response}`` outcomes.  Each call is one ``design.serve``
        row of :mod:`repro_torch.telemetry`.
        """
        from repro_torch.serving import Worker
        with telemetry.root("design.serve"):
            worker = Worker(self, replicas=replicas,
                            round_cycles=round_cycles, steal=steal,
                            autoscaler=autoscaler, check=check)
            report = worker.run(requests)
        return report, worker.responses

    # --------------------------------------------------------- properties
    @property
    def throughput(self):
        """Aggregate multiplications/cycle (replicas x per-bank TP)."""
        return self.plan.throughput * self.spec.replicas

    @property
    def area(self) -> float:
        """Modeled silicon area (um^2), all replicas, including the
        synthesis stress of meeting ``spec.clock_ns`` when set."""
        bits = _timing_bits(self.spec)
        total = 0.0
        for count, cfg in self.plan.configs:
            a = area_model.area_um2(self.spec.bits_a, self.spec.bits_b, cfg)
            if self.spec.clock_ns is not None:
                a *= timing_model.stress(cfg.arch, bits, self.spec.clock_ns)
            total += count * a
        return total * self.spec.replicas

    @property
    def latency_cycles(self) -> int:
        """Cycles from issue to retire for one multiplication."""
        bits = _timing_bits(self.spec)
        return max(_instance_latency(cfg, bits, self.spec.clock_ns)
                   for _, cfg in self.plan.configs)

    @property
    def fmax_estimate(self) -> float:
        """Achievable clock (GHz): the slowest instance's period."""
        bits = _timing_bits(self.spec)
        period = max(_instance_period(cfg, bits, self.spec.clock_ns)
                     for _, cfg in self.plan.configs)
        return 1.0 / period

    @property
    def _stress(self) -> float:
        """Synthesis-stress multiplier of the spec's clock target."""
        if self.spec.clock_ns is None:
            return 1.0
        return timing_model.stress("star", _timing_bits(self.spec),
                                   self.spec.clock_ns)

    @property
    def energy_per_op_pj(self) -> float:
        """Modeled energy per multiplication (pJ)."""
        return power_model.plan_energy_per_op_pj(
            self.spec.bits_a, self.spec.bits_b, self.plan.configs,
            stress=self._stress)

    @property
    def peak_power_mw(self) -> float:
        """Modeled peak power (mW, all replicas) at the spec's clock (or
        the slowest instance's natural period when relaxed)."""
        period = 1.0 / self.fmax_estimate
        return power_model.plan_peak_power_mw(
            self.spec.bits_a, self.spec.bits_b, self.plan.configs,
            clock_ns=period, stress=self._stress) * self.spec.replicas

    def describe(self) -> str:
        extra = " timing_fallback" if self.timing_fallback else ""
        return (f"CompiledDesign[{self.spec.describe()} -> "
                f"{self.plan.describe()}  "
                f"energy={self.energy_per_op_pj:.2f}pJ/op  "
                f"peak={self.peak_power_mw:.2f}mW  "
                f"backend={self.bank.backend}  "
                f"scheduler={self.bank.scheduler.name}  "
                f"device={self.device}{extra}]")

    # --------------------------------------------------------- provenance
    def to_json(self) -> str:
        """The spec's lossless JSON (see DesignSpec.from_json)."""
        return self.spec.to_json()


# ---------------------------------------------------------------- generate

def _resolve_backend(spec: DesignSpec, device: torch.device) -> str:
    if spec.backend == "kernel" and spec.signed:
        raise DesignError("the kernel capability is unsigned-only; use "
                          "backend='core', 'fused' or 'auto' for signed "
                          "designs (fused retires signedness through the "
                          "shared correction pass)")
    if spec.backend != "auto":
        return spec.backend
    # auto: one fused kernel launch per round on the card (every arch has
    # a fused backend); the plain PyTorch path on the CPU
    return "fused" if device.type == "cuda" else "core"


def _achieved_throughput(plan: planner.Plan):
    return sum(Fraction(count, cfg.ct) for count, cfg in plan.configs)


def _resolve_devices(spec: DesignSpec, device: torch.device, devices):
    """One device a replica, or None for a single bank: ``devices`` when
    given, else the first ``spec.replicas`` CUDA cards (``replicas`` x
    the CPU when ``device`` is the CPU)."""
    if spec.replicas == 1:
        return None
    if devices is not None:
        if len(devices) != spec.replicas:
            raise DesignError(
                f"mesh axis {spec.mesh_axis!r} has {len(devices)} devices, "
                f"spec wants {spec.replicas} replicas")
        return tuple(resolve_device(d) for d in devices)
    if device.type == "cpu":
        return (device,) * spec.replicas
    available = torch.cuda.device_count()
    if available < spec.replicas:
        raise DesignError(
            f"{spec.replicas} replicas need {spec.replicas} devices, "
            f"only {available} available (pass explicit devices or "
            f"lower spec.replicas)")
    return tuple(torch.device("cuda", i) for i in range(spec.replicas))


def _resolve_placement(spec: DesignSpec, device, devices):
    """(bank device, replica devices): the bank lies on ``device``, or on
    the first of ``devices`` when only they are given."""
    if device is None and devices:
        device = devices[0]
    device = resolve_device(device)
    return device, _resolve_devices(spec, device, devices)


def _plan_with_timing(spec: DesignSpec):
    plan = planner.plan_throughput(spec.bits_a, spec.bits_b,
                                   spec.throughput,
                                   strict_timing=spec.strict_timing,
                                   objective=spec.objective)
    if _achieved_throughput(plan) != spec.throughput:
        raise DesignError(
            f"throughput {spec.throughput} is not decomposable over the "
            f"planner's CT combinations (best plan sums to "
            f"{_achieved_throughput(plan)}); pick a TP whose fractional "
            f"part is a sum of 1/ct for ct in (2, 3, 4, 6, 8, 12)")
    fallback = False
    bits = _timing_bits(spec)
    if spec.clock_ns is not None:
        bad = _timing_violations(plan, bits, spec.clock_ns)
        if bad and not spec.strict_timing:
            # relaxed winner misses the clock: re-plan over pipelineable
            # candidates only (the paper's strict-timing tables)
            plan = planner.plan_throughput(spec.bits_a, spec.bits_b,
                                           spec.throughput,
                                           strict_timing=True,
                                           objective=spec.objective)
            fallback = True
            bad = _timing_violations(plan, bits, spec.clock_ns)
        if bad:
            worst = max(timing_model.t_comb(cfg.arch, bits) for cfg in bad)
            raise TimingError(
                f"no design meets clock {spec.clock_ns} ns for "
                f"{spec.describe()}: {[cfg.arch for cfg in bad]} bottom "
                f"out at t_comb={worst:.2f} ns and cannot pipeline")
    if spec.latency_budget is not None:
        lat = max(_instance_latency(cfg, bits, spec.clock_ns)
                  for _, cfg in plan.configs)
        if lat > spec.latency_budget:
            raise LatencyError(
                f"{spec.describe()} needs {lat} cycles of latency at "
                f"clock={spec.clock_ns} ns, over the budget of "
                f"{spec.latency_budget}")
    if spec.signed:
        plan = dataclasses.replace(plan, configs=tuple(
            (count, dataclasses.replace(cfg, signed=True))
            for count, cfg in plan.configs))
    # static verification gate: a plan the interval/contract analyzers
    # cannot prove overflow-safe and schedule-conformant never compiles
    verify.assert_plan(spec.bits_a, spec.bits_b, plan.configs,
                       plan.throughput)
    # dataflow gate: every CUDA launch the plan implies is hazard-free,
    # in bounds and within its shared-memory model (nothing executes)
    verify.assert_plan_dataflow(spec.bits_a, spec.bits_b, plan.configs)
    return plan, fallback


def generate(spec: DesignSpec, device=None, devices=None) -> CompiledDesign:
    """Compile ``spec`` (or a registry name) into a :class:`CompiledDesign`
    whose bank runs on ``device``: ``cuda`` by default, raising when no
    CUDA device is present; pass ``device="cpu"`` for the plain path.

    Planning filtered by the timing model (clock + latency), then
    scheduler/backend resolution, bank construction and, for
    ``spec.replicas > 1``, replication over ``devices`` (one a replica;
    by default the first ``replicas`` cards, or the CPU repeated when
    ``device="cpu"``).
    """
    if isinstance(spec, str):
        from .registry import get
        spec = get(spec)
    device, devices = _resolve_placement(spec, device, devices)
    plan, fallback = _plan_with_timing(spec)
    backend = _resolve_backend(spec, device)
    bank = Bank(plan, spec.bits_a, spec.bits_b, backend=backend,
                scheduler=spec.scheduler, device=device)
    return CompiledDesign(spec, plan, bank, devices=devices,
                          timing_fallback=fallback)


def compile_plan(spec: DesignSpec, configs, device=None,
                 devices=None) -> CompiledDesign:
    """Compile ``spec`` with an EXPLICIT instance list ``[(count,
    MCIMConfig), ...]``, bypassing the planner's pick; it must sum to
    exactly ``spec.throughput`` and meet the spec's clock/latency.
    ``device`` and ``devices`` as in :func:`generate`."""
    device, devices = _resolve_placement(spec, device, devices)
    configs = tuple((int(count), cfg) for count, cfg in configs)
    if spec.signed:
        configs = tuple((count, dataclasses.replace(cfg, signed=True))
                        for count, cfg in configs)
    area = sum(count * area_model.area_um2(spec.bits_a, spec.bits_b, cfg)
               for count, cfg in configs)
    plan = planner.Plan(configs=configs, throughput=spec.throughput,
                        area=area)
    if _achieved_throughput(plan) != spec.throughput:
        raise DesignError(
            f"explicit configs sum to TP={_achieved_throughput(plan)}, "
            f"spec wants {spec.throughput}")
    bits = _timing_bits(spec)
    if spec.strict_timing:
        bad = [cfg for _, cfg in configs
               if not timing_model.pipelineable(cfg.arch, cfg.adder)]
        if bad:
            raise TimingError(f"strict spec given non-pipelineable "
                              f"instances: {[cfg.arch for cfg in bad]}")
    if spec.clock_ns is not None:
        bad = _timing_violations(plan, bits, spec.clock_ns)
        if bad:
            raise TimingError(
                f"explicit configs miss clock {spec.clock_ns} ns: "
                f"{[cfg.arch for cfg in bad]}")
    if spec.latency_budget is not None:
        lat = max(_instance_latency(cfg, bits, spec.clock_ns)
                  for _, cfg in configs)
        if lat > spec.latency_budget:
            raise LatencyError(f"explicit configs need {lat} cycles, "
                               f"over the budget of {spec.latency_budget}")
    # same static gate generate() applies: explicit instance lists must
    # prove safe before a bank is built around them
    verify.assert_plan(spec.bits_a, spec.bits_b, plan.configs,
                       plan.throughput)
    verify.assert_plan_dataflow(spec.bits_a, spec.bits_b, plan.configs)
    backend = _resolve_backend(spec, device)
    bank = Bank(plan, spec.bits_a, spec.bits_b, backend=backend,
                scheduler=spec.scheduler, device=device)
    return CompiledDesign(spec, plan, bank, devices=devices)
