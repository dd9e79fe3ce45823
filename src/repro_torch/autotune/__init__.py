"""repro_torch.autotune: Pareto-front search over MCIM decompositions.

The port's copy of the reference package's ``autotune``.
``designs.generate`` compiles ONE plan per spec.  This subsystem
searches the whole decomposition space instead and returns the
area/latency/fmax/energy/peak-power Pareto front -- the multi-objective
view the paper's energy and peak-power claims (up to 33% / 65% vs Star)
live on, and the substrate later architecture work plugs new planner
archs into:

    from repro_torch import autotune, designs

    front = autotune.search(designs.DesignSpec(32, 32, "1/3"))
    print(front.describe())             # non-dominated candidates
    d = front.best("energy").compile()  # any point -> CompiledDesign
    d = front.best("area").compile(device="cpu")   # the plain path

    # or in one call (generate() stays the single-plan path):
    d = autotune.generate_best(spec, objective="peak_power")

Fronts are cached on a spec-space hash (JSON files, see ``cache``):
re-running the same sweep loads the stored front with zero re-scores.
Scoring is pure cost-model arithmetic (``core.area_model``,
``core.power_model``, ``core.timing_model``) and every candidate
compiles through ``designs.compile_plan`` under the same timing gate
``generate()`` applies.
"""
from .pareto import Candidate, ParetoFront, pareto_front, OBJECTIVES
from .candidates import (enumerate_configs, ct_decompositions, CT_SET,
                         MAX_CANDIDATES)
from .search import search, generate_best, score
from .cache import space_key, cache_dir_path, AUTOTUNE_VERSION

__all__ = [
    "Candidate", "ParetoFront", "pareto_front", "OBJECTIVES",
    "enumerate_configs", "ct_decompositions", "CT_SET", "MAX_CANDIDATES",
    "search", "generate_best", "score",
    "space_key", "cache_dir_path", "AUTOTUNE_VERSION",
]
