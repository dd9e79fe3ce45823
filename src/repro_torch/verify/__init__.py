"""repro_torch.verify: static design verification -- no execution required.

The plan-time gate of the port, the counterpart of the reference
package's ``verify`` gate:

  * :mod:`.intervals`  -- abstract interpretation of the limb pipeline:
    every uint32 carry-save column provably stays below 2**32, for the
    exact dataflow of each architecture on each substrate (and, in
    :func:`~.intervals.analyze_row_tiles`, for the port's CUDA row-tile
    kernels);
  * :mod:`.contracts`  -- schedule contracts: partial-product coverage
    (each a_i*b_j exactly once, Karatsuba combine as a polynomial
    identity), scratch/out widths vs the proven requirement, Plan
    throughput sums, scheduler determinism/completeness, and bank
    dispatch staticness on fake tensors (``FakeTensorMode``);
  * :mod:`.dataflow`   -- static proofs of every CUDA launch a plan
    implies, from the kernel packages' launch contracts
    (:mod:`repro_torch.kernels.introspect`): conformance to the
    launchers' arithmetic, hazard freedom over the output rows and the
    fused dispatch's gather and read-back maps, block and window
    bounds, the shared-memory model and budget, and a static
    bytes/operations roofline per launch;
  * :mod:`.lint`       -- AST pass over the port's source flagging host
    syncs on the bank round's tensors, non-static scheduler state,
    environment reads outside a stated allow-list, fallbacks that hide
    a kernel, and imports of the reference or jax.

``python -m repro_torch.verify`` sweeps the design registry plus the
autotuner's enumeration vocabulary and writes
``VERIFY_torch_report.json``.  ``designs.generate`` and
``designs.compile_plan`` call :func:`assert_plan` and then
:func:`assert_plan_dataflow` at plan time (``autotune.search`` the
first), so a design that cannot be proven safe errors before it ever
executes; the port refuses the plans the reference's ``assert_plan``
refuses, with the same violations.
"""
from __future__ import annotations

import functools

from . import intervals, contracts, lint
from .intervals import IntervalReport, Violation, analyze
from .contracts import (check_coverage, check_widths, check_throughput,
                        check_fused_schedule, check_fused_widths,
                        check_fused_plan, check_all_schedulers,
                        check_bank_static)
from .lint import lint_tree, lint_source

__all__ = [
    "intervals", "contracts", "lint", "dataflow",
    "IntervalReport", "Violation", "VerificationError", "DataflowError",
    "analyze", "check_coverage", "check_widths", "check_throughput",
    "check_fused_schedule", "check_fused_widths", "check_fused_plan",
    "check_all_schedulers", "check_bank_static",
    "lint_tree", "lint_source",
    "verify_instance", "verify_plan", "assert_plan", "verify_design",
    "verify_plan_dataflow", "assert_plan_dataflow",
]

#: substrates swept per instance (kernel skipped for signed configs,
#: whose capability is core-only; fused handles signedness through the
#: bank-wide correction pass, so it is swept unconditionally)
_SUBSTRATES = ("core", "kernel", "fused")


class VerificationError(ValueError):
    """A design the static analyzers cannot prove safe.

    Raised by :func:`assert_plan` at plan time: the design never
    executes.  ``violations`` carries the structured findings.
    """

    def __init__(self, violations):
        self.violations = tuple(violations)
        lines = [v.describe() for v in self.violations]
        super().__init__(
            f"{len(lines)} verification violation(s):\n  " +
            "\n  ".join(lines))


class DataflowError(VerificationError):
    """A CUDA launch the dataflow analyzer cannot prove safe.

    Raised by :func:`assert_plan_dataflow`: a hazard, bounds, shared
    memory or window-table finding on the launches a plan implies.
    """


# after DataflowError, as in the reference
from . import dataflow                              # noqa: E402
from .dataflow import verify_plan_dataflow          # noqa: E402


@functools.lru_cache(maxsize=4096)
def verify_instance(bits_a: int, bits_b: int, cfg) -> tuple:
    """All violations of one MCIMConfig at the given widths.

    Cached (MCIMConfig is frozen/hashable) so plan-time gating in
    ``generate()``/``search()`` costs one analysis per distinct design
    point per process, not one per call.
    """
    out = []
    out.extend(contracts.check_coverage(bits_a, bits_b, cfg))
    out.extend(contracts.check_widths(bits_a, bits_b, cfg))
    out.extend(contracts.check_fused_schedule(bits_a, bits_b, cfg))
    out.extend(contracts.check_fused_widths(bits_a, bits_b, cfg))
    for sub in _SUBSTRATES:
        if sub == "kernel" and cfg.signed:
            continue
        out.extend(intervals.analyze(bits_a, bits_b, cfg,
                                     substrate=sub).violations)
    return tuple(out)


def verify_plan(bits_a: int, bits_b: int, configs,
                throughput=None) -> tuple:
    """All violations of a plan: throughput sum + every instance + the
    fused super-geometry (idle-step masks, schedule table consistency)."""
    out = []
    configs = tuple(configs)
    if throughput is not None:
        out.extend(contracts.check_throughput(configs, throughput))
    for _, cfg in configs:
        out.extend(verify_instance(bits_a, bits_b, cfg))
    out.extend(contracts.check_fused_plan(bits_a, bits_b, configs))
    return tuple(out)


def assert_plan(bits_a: int, bits_b: int, configs,
                throughput=None) -> None:
    """Raise :class:`VerificationError` unless the plan proves safe.

    The plan-time gate ``designs.generate`` / ``designs.compile_plan``
    and ``autotune.search`` run on every candidate before compiling or
    scoring it.
    """
    violations = verify_plan(bits_a, bits_b, configs, throughput)
    if violations:
        raise VerificationError(violations)


def assert_plan_dataflow(bits_a: int, bits_b: int, configs,
                         budget=None) -> None:
    """Raise :class:`DataflowError` unless every launch proves safe.

    The fourth plan-time gate: analyzes (never executes) the
    per-instance and fused CUDA launches the plan implies and rejects
    hazards, out-of-bounds spans and windows, launches that depart from
    their launchers' arithmetic, and shared-memory model/budget breaks.
    Results are cached per distinct launch geometry inside
    :mod:`.dataflow`, so repeated gating is cheap.
    """
    violations = dataflow.verify_plan_dataflow(bits_a, bits_b,
                                               tuple(configs),
                                               budget=budget)
    if violations:
        raise DataflowError(violations)


def verify_design(design) -> tuple:
    """All violations of a ``CompiledDesign`` (post-hoc checking)."""
    return verify_plan(design.spec.bits_a, design.spec.bits_b,
                       design.plan.configs, design.plan.throughput)
