"""DesignSpec: the declarative input of the design generator.

The paper's deliverable is a *generator* that "offers customization in
terms of throughput, latency, and clock frequency".  A ``DesignSpec``
is exactly that customization surface, frozen and serializable:

  * operand widths        -- ``bits_a`` x ``bits_b``
  * throughput            -- multiplications/cycle, fractional allowed
                             (``Fraction``, float, int or "7/2" string)
  * clock target          -- ``clock_ns`` period (or build the spec via
                             :meth:`DesignSpec.at_fmax`); designs that
                             cannot meet it are filtered out by
                             :func:`repro_torch.designs.generate`
  * latency budget        -- max pipeline depth in cycles at the target
  * strict_timing         -- restrict planning to pipelineable designs
                             up front (paper Tables IV/VI/VIII)
  * signed                -- two's-complement operands
  * scheduler / backend   -- bank dispatch policy and execution
                             substrate ("auto" resolves per platform)
  * replicas / mesh_axis  -- sharded multi-bank replication
  * objective             -- scalar the planner ranks candidate designs
                             by: "area" (default, the paper's tables)
                             or "energy" (the low-power registry
                             points); the reference package's autotuner searches
                             the full multi-objective front instead

``to_json``/``from_json`` round-trip losslessly (the throughput
Fraction is carried as an exact "num/den" string), so BENCH artifacts
and CI runs can embed full design provenance and recompile the very
same design later.
"""
from __future__ import annotations

import dataclasses
import json
from fractions import Fraction

#: single owner of the TP quantization bound: the spec quantizes with
#: exactly the denominator plan_throughput will use, so a spec's
#: throughput always equals its compiled plan's.
from repro_torch.core.planner import MAX_TP_DENOMINATOR, OBJECTIVES

_BACKENDS = ("auto", "core", "kernel", "fused")
_SPEC_VERSION = 1


class DesignError(ValueError):
    """A spec that cannot be compiled into a design."""


class TimingError(DesignError):
    """No planner design meets the spec's clock target."""


class LatencyError(DesignError):
    """The design's pipeline depth exceeds the spec's latency budget."""


@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """Declarative multiplier-bank design point (see module docstring)."""
    bits_a: int
    bits_b: int
    throughput: Fraction
    clock_ns: float | None = None       # target clock period (None=relaxed)
    latency_budget: int | None = None   # max latency in cycles
    strict_timing: bool = False
    signed: bool = False
    scheduler: str = "round_robin"
    backend: str = "auto"               # auto | core | kernel | fused
    replicas: int = 1                   # bank replicas over a mesh axis
    mesh_axis: str = "data"
    objective: str = "area"             # planner ranking: area | energy

    def __post_init__(self):
        tp = Fraction(self.throughput).limit_denominator(MAX_TP_DENOMINATOR)
        object.__setattr__(self, "throughput", tp)
        if self.bits_a < 1 or self.bits_b < 1:
            raise DesignError("operand widths must be >= 1 bit")
        if tp <= 0:
            raise DesignError(f"throughput must be positive, got {tp}")
        if self.clock_ns is not None and self.clock_ns <= 0:
            raise DesignError(f"clock_ns must be positive, got {self.clock_ns}")
        if self.latency_budget is not None and self.latency_budget < 1:
            raise DesignError("latency_budget must be >= 1 cycle")
        if self.backend not in _BACKENDS:
            raise DesignError(f"backend must be one of {_BACKENDS}")
        if self.replicas < 1:
            raise DesignError("replicas must be >= 1")
        if self.objective not in OBJECTIVES:
            raise DesignError(f"objective must be one of {OBJECTIVES}")

    # ------------------------------------------------------------ builders
    @classmethod
    def at_fmax(cls, bits_a: int, bits_b: int, throughput,
                fmax_ghz: float, **kw) -> "DesignSpec":
        """Spec from a clock-*frequency* target instead of a period."""
        if fmax_ghz <= 0:
            raise DesignError(f"fmax_ghz must be positive, got {fmax_ghz}")
        return cls(bits_a, bits_b, throughput, clock_ns=1.0 / fmax_ghz, **kw)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """JSON-safe dict; the exact inverse of :meth:`from_dict`."""
        return {
            "version": _SPEC_VERSION,
            "bits_a": self.bits_a,
            "bits_b": self.bits_b,
            "throughput": f"{self.throughput.numerator}/"
                          f"{self.throughput.denominator}",
            "clock_ns": self.clock_ns,
            "latency_budget": self.latency_budget,
            "strict_timing": self.strict_timing,
            "signed": self.signed,
            "scheduler": self.scheduler,
            "backend": self.backend,
            "replicas": self.replicas,
            "mesh_axis": self.mesh_axis,
            "objective": self.objective,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DesignSpec":
        d = dict(d)
        version = d.pop("version", _SPEC_VERSION)
        if version > _SPEC_VERSION:
            raise DesignError(f"spec version {version} is newer than this "
                              f"library's {_SPEC_VERSION}")
        if "fmax_ghz" in d and d.get("clock_ns") is None:
            d["clock_ns"] = 1.0 / float(d.pop("fmax_ghz"))
        else:
            d.pop("fmax_ghz", None)
        return cls(throughput=Fraction(d.pop("throughput")), **d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DesignSpec":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------- display
    def describe(self) -> str:
        parts = [f"{self.bits_a}x{self.bits_b}b", f"TP={self.throughput}"]
        if self.clock_ns is not None:
            parts.append(f"clock={self.clock_ns}ns")
        if self.latency_budget is not None:
            parts.append(f"latency<={self.latency_budget}cy")
        if self.strict_timing:
            parts.append("strict")
        if self.signed:
            parts.append("signed")
        if self.replicas > 1:
            parts.append(f"x{self.replicas}@{self.mesh_axis}")
        if self.objective != "area":
            parts.append(f"obj={self.objective}")
        return "DesignSpec(" + " ".join(parts) + ")"
