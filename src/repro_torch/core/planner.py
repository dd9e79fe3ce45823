"""Design-point planner: pick the best MCIM design for an application.

Encodes the paper's Sec. V-D guidance (Table VIII) as an executable
policy, refined by the area model:

  * strict timing           -> FF (no feedback loop, pipelineable)
  * relaxed timing, CT >= 3 -> FB (deepest resource sharing)
  * bits >= 128             -> Karatsuba (CT=3), recursion level by size
  * TP fractional (i/j)     -> mixture of Star and MCIM instances
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

from .mcim import MCIMConfig
from . import area_model
from . import power_model

#: planning objectives: the scalar each candidate design is ranked by
OBJECTIVES = ("area", "energy")


def _objective_key(bits_a: int, bits_b: int, objective: str):
    if objective == "area":
        return lambda c: area_model.mcim_area(bits_a, bits_b, c).total
    if objective == "energy":
        return lambda c: power_model.mcim_energy(bits_a, bits_b, c).total
    raise ValueError(f"objective must be one of {OBJECTIVES}")

#: Fractional TPs are quantized to this denominator bound (the largest
#: CT combination the Sec. V-B planner explores).  repro_torch.designs mirrors
#: it so a DesignSpec's throughput always matches the plan it compiles.
MAX_TP_DENOMINATOR = 12


@dataclasses.dataclass(frozen=True)
class Plan:
    """A multiplier bank achieving an aggregate throughput."""
    configs: tuple            # tuple[(count, MCIMConfig)]
    throughput: Fraction
    area: float               # um^2 (area-model estimate)

    def describe(self) -> str:
        parts = []
        for c, cfg in self.configs:
            detail = [f"ct={cfg.ct}"]
            if cfg.arch == "karatsuba":
                detail.append(f"K={cfg.levels}")
            if cfg.adder != "1ca":       # e.g. 3CA: a genuinely different
                detail.append(cfg.adder)  # design, must not print as 1CA
            if cfg.signed:
                detail.append("signed")
            parts.append(f"{c}x {cfg.arch}({','.join(detail)})")
        return " + ".join(parts) + f"  TP={self.throughput}  area={self.area:.0f}um2"


def best_single(bits_a: int, bits_b: int, ct: int,
                strict_timing: bool = False,
                objective: str = "area") -> MCIMConfig:
    """Best single MCIM design for a given CT (paper Table VIII policy).

    ``objective`` ranks the candidate set by the area model (default,
    the paper's tables) or by the power model's per-op energy (the
    low-power registry points); the candidate set itself is identical.
    """
    if ct == 1:
        return MCIMConfig(arch="star", ct=1)
    candidates = []
    if ct == 2:
        candidates.append(MCIMConfig(arch="ff", ct=2))
        if not strict_timing:
            candidates.append(MCIMConfig(arch="fb", ct=2))
    else:
        if not strict_timing:
            candidates.append(MCIMConfig(arch="fb", ct=ct))
        if ct == 3:
            best_k = best_karatsuba_levels(bits_a, bits_b)
            candidates.append(MCIMConfig(arch="karatsuba", ct=3, levels=best_k))
            if not strict_timing:
                candidates.append(MCIMConfig(arch="karatsuba", ct=3,
                                             levels=best_k, adder="3ca"))
    if not candidates:   # strict timing && ct>2 without FB: pipeline FF anyway
        candidates.append(MCIMConfig(arch="ff", ct=ct))
    return min(candidates, key=_objective_key(bits_a, bits_b, objective))


def best_karatsuba_levels(bits_a: int, bits_b: int, max_levels: int = 4) -> int:
    """Optimal recursion depth by the area model (paper: size-dependent)."""
    best, best_area = 1, float("inf")
    for k in range(1, max_levels + 1):
        a = area_model.mcim_area(bits_a, bits_b,
                                 MCIMConfig(arch="karatsuba", ct=3, levels=k)).total
        if a < best_area:
            best, best_area = k, a
    return best


def plan_throughput(bits_a: int, bits_b: int, tp: Fraction | float,
                    strict_timing: bool = False,
                    objective: str = "area") -> Plan:
    """Multiplier bank for a (possibly fractional) multiplications/cycle TP.

    Paper use case 1: TP = i/j with i/j not an integer, e.g. 3.5 -> three
    Star multipliers + one CT=2 MCIM instead of four Stars.
    """
    tp = Fraction(tp).limit_denominator(MAX_TP_DENOMINATOR)
    n_full = math.floor(tp)
    frac = tp - n_full
    configs = []
    if n_full:
        configs.append((n_full, MCIMConfig(arch="star", ct=1)))
    if frac:
        ct = int(1 / frac) if (1 / frac) == int(1 / frac) else None
        if ct is not None:
            configs.append((1, best_single(bits_a, bits_b, ct, strict_timing,
                                           objective)))
        else:
            # e.g. 5/6 -> one CT=2 + one CT=3 (paper Sec. V-B combinations)
            remaining = frac
            for ct_try in (2, 3, 4, 6, 8, 12):
                piece = Fraction(1, ct_try)
                while remaining >= piece:
                    configs.append((1, best_single(bits_a, bits_b, ct_try,
                                                   strict_timing, objective)))
                    remaining -= piece
                if remaining == 0:
                    break
    area = sum(c * area_model.area_um2(bits_a, bits_b, cfg)
               for c, cfg in configs)
    return Plan(configs=tuple(configs), throughput=tp, area=area)


def star_bank_area(bits_a: int, bits_b: int, tp: Fraction | float) -> float:
    """Area of the conventional round-up-to-integer Star bank."""
    n = math.ceil(Fraction(tp).limit_denominator(MAX_TP_DENOMINATOR))
    return n * area_model.area_um2(bits_a, bits_b, MCIMConfig(arch="star", ct=1))
