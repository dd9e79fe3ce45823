"""Named-design registry: reusable, provenance-carrying design points.

``register(name, spec)`` publishes a :class:`~.spec.DesignSpec` under a
stable name; ``get(name)`` / ``generate(name)`` recompiles it anywhere
(benchmarks, CI, serving) with full provenance.  The paper's Table-VIII
"best design per width/timing" points and the Sec. V-E use-case banks
ship pre-registered, so e.g. ``designs.generate("tp3p5_w32")`` is the
headline TP=3.5 deployment story in one call.
"""
from __future__ import annotations

from fractions import Fraction

from .spec import DesignSpec

_REGISTRY: dict = {}


def register(name: str, spec: DesignSpec, *,
             overwrite: bool = False) -> DesignSpec:
    """Publish ``spec`` under ``name`` (refuses silent redefinition)."""
    if not overwrite and name in _REGISTRY and _REGISTRY[name] != spec:
        raise ValueError(f"design {name!r} is already registered with a "
                         f"different spec; pass overwrite=True to replace")
    _REGISTRY[name] = spec
    return spec


def get(name: str) -> DesignSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown design {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def names() -> tuple:
    """Registered design names, sorted."""
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------- paper designs
# Table VIII: the paper's best design per (width, timing) row.  Strict
# rows carry their clock target so generate() reproduces the table's
# timing-aware selection; relaxed rows leave the clock unconstrained.
TABLE_VIII = {
    "tbl8_w8_relaxed": DesignSpec(8, 8, Fraction(1, 2)),
    "tbl8_w16_strict": DesignSpec(16, 16, Fraction(1, 2), clock_ns=0.31,
                                  strict_timing=True),
    "tbl8_w16_relaxed": DesignSpec(16, 16, Fraction(1, 2)),
    "tbl8_w32_strict": DesignSpec(32, 32, Fraction(1, 2), clock_ns=0.31,
                                  strict_timing=True),
    "tbl8_w32_relaxed": DesignSpec(32, 32, Fraction(1, 2)),
    "tbl8_w128_strict": DesignSpec(128, 128, Fraction(1, 3), clock_ns=0.80,
                                   strict_timing=True),
}

# Sec. V-B / V-E use-case banks (the fractional-throughput stories).
# Naming: "p" is a decimal point (tp3p5 = 3.5); exact fractions spell
# out the division (tp5over6 = 5/6) to avoid misreading 5/6 as 5.6.
USE_CASES = {
    "tp3p5_w32": DesignSpec(32, 32, Fraction(7, 2)),
    "tp5over6_w128": DesignSpec(128, 128, Fraction(5, 6)),
}

# Low-power companions to the Table-VIII rows: the best-ENERGY design
# per width at TP=1/2 (objective="energy" makes generate() rank the
# planner's candidate set by the power model -- the point the
# autotuner's Pareto front puts at its energy-minimal end), covering
# the paper's 8-128 bit energy/peak-power claim (up to 33% / 65%).
LOW_POWER = {
    f"tbl8_w{_b}_lowpower": DesignSpec(_b, _b, Fraction(1, 2),
                                       objective="energy")
    for _b in (8, 16, 32, 64, 128)
}

for _name, _spec in {**TABLE_VIII, **USE_CASES, **LOW_POWER}.items():
    register(_name, _spec)
del _name, _spec
