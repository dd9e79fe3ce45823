"""Candidates and Pareto fronts for the MCIM design autotuner.

A :class:`Candidate` is one concrete decomposition of a
:class:`~repro_torch.designs.DesignSpec`'s throughput into MCIM instances,
scored on the five objectives the paper's tables report:

  area (um^2) . latency (cycles) . fmax (GHz) . energy/op (pJ) .
  peak power (mW)

:func:`pareto_front` splits a candidate pool into the non-dominated
front and the dominated rest.  Everything here is deterministic and
order-invariant: the front is a set property of the pool, and each
dominated candidate records the *lexicographically smallest* dominating
candidate key as provenance, so shuffling the enumeration order can
never change the result (a property the hypothesis suite asserts).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.mcim import MCIMConfig
from repro_torch.designs import DesignSpec, compile_plan

#: objective name -> (metric attribute, maximize?)
OBJECTIVES = {
    "area": ("area_um2", False),
    "latency": ("latency_cycles", False),
    "fmax": ("fmax_ghz", True),
    "energy": ("energy_per_op_pj", False),
    "peak_power": ("peak_power_mw", False),
}


def _cfg_dict(cfg: MCIMConfig) -> dict:
    return {"arch": cfg.arch, "ct": cfg.ct, "levels": cfg.levels,
            "adder": cfg.adder, "signed": cfg.signed}


def _cfg_from_dict(d: dict) -> MCIMConfig:
    return MCIMConfig(**d)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored decomposition: spec + explicit instance list + metrics."""
    spec: DesignSpec
    configs: tuple                 # tuple[(count, MCIMConfig)]
    area_um2: float
    latency_cycles: int
    fmax_ghz: float
    energy_per_op_pj: float
    peak_power_mw: float
    slack_ns: tuple                # per instance, at the scoring period
    dominated_by: str | None = None

    @property
    def key(self) -> str:
        """Canonical identity: the sorted instance multiset + the spec.
        Stable across enumeration order and process restarts."""
        insts = sorted(
            f"{c}x{cfg.arch}.ct{cfg.ct}.k{cfg.levels}.{cfg.adder}"
            f"{'.s' if cfg.signed else ''}"
            for c, cfg in self.configs)
        return f"{self.spec.bits_a}x{self.spec.bits_b}" \
               f"@{self.spec.throughput}:" + "+".join(insts)

    def objective_vector(self) -> tuple:
        """All five metrics as minimized values (period, not fmax)."""
        return (self.area_um2, float(self.latency_cycles),
                1.0 / self.fmax_ghz, self.energy_per_op_pj,
                self.peak_power_mw)

    def dominates(self, other: "Candidate") -> bool:
        a, b = self.objective_vector(), other.objective_vector()
        return all(x <= y for x, y in zip(a, b)) and \
            any(x < y for x, y in zip(a, b))

    def compile(self, device=None):
        """Materialize this candidate as an executable CompiledDesign on
        ``device`` (``cuda`` by default; ``"cpu"`` for the plain path),
        through ``designs.compile_plan`` -- the same timing gate."""
        return compile_plan(self.spec, self.configs, device=device)

    def describe(self) -> str:
        insts = " + ".join(f"{c}x {cfg.arch}(ct={cfg.ct}"
                           + (f",K={cfg.levels}" if cfg.arch == "karatsuba"
                              else "")
                           + (f",{cfg.adder}" if cfg.adder != "1ca" else "")
                           + ")"
                           for c, cfg in self.configs)
        return (f"{insts}  area={self.area_um2:.0f}um2 "
                f"lat={self.latency_cycles}cy fmax={self.fmax_ghz:.2f}GHz "
                f"E={self.energy_per_op_pj:.2f}pJ/op "
                f"Ppeak={self.peak_power_mw:.2f}mW")

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "configs": [[c, _cfg_dict(cfg)] for c, cfg in self.configs],
            "area_um2": self.area_um2,
            "latency_cycles": self.latency_cycles,
            "fmax_ghz": self.fmax_ghz,
            "energy_per_op_pj": self.energy_per_op_pj,
            "peak_power_mw": self.peak_power_mw,
            "slack_ns": list(self.slack_ns),
            "dominated_by": self.dominated_by,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        return cls(
            spec=DesignSpec.from_dict(d["spec"]),
            configs=tuple((int(c), _cfg_from_dict(cfg))
                          for c, cfg in d["configs"]),
            area_um2=d["area_um2"],
            latency_cycles=d["latency_cycles"],
            fmax_ghz=d["fmax_ghz"],
            energy_per_op_pj=d["energy_per_op_pj"],
            peak_power_mw=d["peak_power_mw"],
            slack_ns=tuple(d["slack_ns"]),
            dominated_by=d.get("dominated_by"),
        )


def pareto_front(candidates) -> tuple:
    """Split ``candidates`` into (front, dominated), order-invariantly.

    front: candidates no other candidate dominates, sorted by area;
    dominated: the rest, each carrying ``dominated_by`` = the smallest
    (by key) candidate that dominates it.  Duplicate keys collapse to
    one representative.
    """
    # canonical processing order -> deterministic output for any input order
    pool = sorted({c.key: c for c in candidates}.values(),
                  key=lambda c: c.key)
    front, dominated = [], []
    for c in pool:
        dominators = sorted(o.key for o in pool if o.dominates(c))
        if dominators:
            dominated.append(dataclasses.replace(
                c, dominated_by=dominators[0]))
        else:
            front.append(c)
    front.sort(key=lambda c: (c.objective_vector(), c.key))
    dominated.sort(key=lambda c: (c.objective_vector(), c.key))
    return tuple(front), tuple(dominated)


class ParetoFront:
    """The autotuner's result: the non-dominated set plus provenance.

    ``front`` lists the surviving candidates (sorted area-ascending);
    ``dominated`` keeps every pruned candidate with the key of a
    dominator, so a sweep's full decision record is serializable.
    """

    def __init__(self, front, dominated=(), *, space_key: str = "",
                 n_scored: int = 0, from_cache: bool = False):
        self.front = tuple(front)
        self.dominated = tuple(dominated)
        self.space_key = space_key
        self.n_scored = n_scored
        self.from_cache = from_cache

    def __len__(self) -> int:
        return len(self.front)

    def __iter__(self):
        return iter(self.front)

    def best(self, objective: str = "energy") -> Candidate:
        """The front point minimizing (or, for fmax, maximizing) one
        objective; ties break on the canonical key."""
        try:
            attr, maximize = OBJECTIVES[objective]
        except KeyError:
            raise ValueError(f"objective must be one of "
                             f"{sorted(OBJECTIVES)}") from None
        if not self.front:
            raise ValueError("empty Pareto front")
        sign = -1.0 if maximize else 1.0
        return min(self.front,
                   key=lambda c: (sign * getattr(c, attr), c.key))

    def best_meeting(self, min_throughput, objective: str = "area"):
        """Cheapest front point whose throughput covers ``min_throughput``
        (ops/cycle), or None when no front point is fast enough.

        This is the serving autoscaler's consultation hook
        (``repro_torch.serving.Autoscaler.recommend``): under sustained load
        below the provisioned TP, re-plan onto the least-``objective``
        design that still sustains the observed rate.  Unlike
        :meth:`best` it filters on a throughput floor first, and returns
        None instead of raising so a controller can fall back to "keep
        the current design".
        """
        try:
            attr, maximize = OBJECTIVES[objective]
        except KeyError:
            raise ValueError(f"objective must be one of "
                             f"{sorted(OBJECTIVES)}") from None
        feasible = [c for c in self.front
                    if float(c.spec.throughput) >= float(min_throughput)]
        if not feasible:
            return None
        sign = -1.0 if maximize else 1.0
        return min(feasible,
                   key=lambda c: (sign * getattr(c, attr), c.key))

    def describe(self) -> str:
        lines = [f"ParetoFront[{len(self.front)} points, "
                 f"{len(self.dominated)} dominated, "
                 f"scored={self.n_scored}"
                 + (", cached" if self.from_cache else "") + "]"]
        lines += [f"  {c.describe()}" for c in self.front]
        return "\n".join(lines)

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "space_key": self.space_key,
            "n_scored": self.n_scored,
            "front": [c.to_dict() for c in self.front],
            "dominated": [c.to_dict() for c in self.dominated],
        }

    @classmethod
    def from_dict(cls, d: dict, *, from_cache: bool = False) -> "ParetoFront":
        return cls(
            front=[Candidate.from_dict(c) for c in d["front"]],
            dominated=[Candidate.from_dict(c) for c in d["dominated"]],
            space_key=d.get("space_key", ""),
            n_scored=0 if from_cache else d.get("n_scored", 0),
            from_cache=from_cache,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str, *, from_cache: bool = False) -> "ParetoFront":
        return cls.from_dict(json.loads(s), from_cache=from_cache)
