"""search(): score every MCIM decomposition, keep the Pareto front.

The search layer: instead of ``generate()``'s
pick-one-plan behavior, enumerate every candidate decomposition of a
``DesignSpec`` (``candidates.enumerate_configs``), score each on the
five paper objectives (area / latency / fmax / energy / peak power --
all from the calibrated ``core`` models, no execution needed), and
return the non-dominated :class:`~.pareto.ParetoFront` with dominated-
by provenance and per-instance timing slack.

Scoring mirrors ``CompiledDesign``'s properties exactly (same stress
multiplier, same instance-latency/period helpers), so a candidate's
metrics equal those of ``candidate.compile()`` -- the front IS a set of
compilable designs, not a separate estimate.
"""
from __future__ import annotations

import dataclasses

from repro_torch import verify
from repro_torch.core import area_model, power_model, timing_model
from repro_torch.designs import DesignSpec
from repro_torch.designs.compile import (_instance_latency, _instance_period,
                                   _timing_bits)
from .candidates import enumerate_configs
from .pareto import Candidate, ParetoFront, pareto_front
from . import cache as _cache


def score(spec: DesignSpec, configs) -> Candidate:
    """Score one explicit decomposition on all five objectives."""
    if spec.signed:
        configs = tuple((c, dataclasses.replace(cfg, signed=True))
                        for c, cfg in configs)
    # static gate: an unprovable candidate never reaches the front (the
    # per-instance analyses are lru-cached, so sweeping thousands of
    # candidates re-verifies each distinct design point once)
    verify.assert_plan(spec.bits_a, spec.bits_b, configs,
                       spec.throughput)
    bits = _timing_bits(spec)
    stress = 1.0 if spec.clock_ns is None else \
        timing_model.stress("star", bits, spec.clock_ns)
    area = sum(c * area_model.area_um2(spec.bits_a, spec.bits_b, cfg)
               for c, cfg in configs) * stress * spec.replicas
    latency = max(_instance_latency(cfg, bits, spec.clock_ns)
                  for _, cfg in configs)
    periods = [_instance_period(cfg, bits, spec.clock_ns)
               for _, cfg in configs]
    period = max(periods)
    energy = power_model.plan_energy_per_op_pj(
        spec.bits_a, spec.bits_b, configs, stress=stress)
    peak = power_model.plan_peak_power_mw(
        spec.bits_a, spec.bits_b, configs, clock_ns=period,
        stress=stress) * spec.replicas
    slack = tuple(round(period - p, 6) for p in periods)
    return Candidate(spec=spec, configs=tuple(configs),
                     area_um2=area, latency_cycles=latency,
                     fmax_ghz=1.0 / period, energy_per_op_pj=energy,
                     peak_power_mw=peak, slack_ns=slack)


def _as_specs(spec_space) -> tuple:
    from repro_torch.designs import registry
    if isinstance(spec_space, (DesignSpec, str)):
        spec_space = [spec_space]
    return tuple(registry.get(s) if isinstance(s, str) else s
                 for s in spec_space)


def search(spec_space, *, use_cache: bool = True,
           cache_dir: str | None = None) -> ParetoFront:
    """Sweep a spec space and return its Pareto front.

    ``spec_space`` is one ``DesignSpec`` (or registered name), or an
    iterable of them; candidates from every spec are pooled into one
    front (pool comparable problems -- same widths/TP -- unless you
    deliberately want a cross-problem sweep).  Results are cached on
    the spec-space hash: a repeated ``search`` over the same space
    loads the stored front and performs ZERO re-scores
    (``front.from_cache`` / ``front.n_scored`` report which path ran).
    """
    specs = _as_specs(spec_space)
    if not specs:
        raise ValueError("empty spec space")
    key = _cache.space_key(specs)
    if use_cache:
        hit = _cache.load(key, cache_dir)
        if hit is not None:
            return hit
    scored = []
    for spec in specs:
        for configs in enumerate_configs(spec):
            scored.append(score(spec, configs))
    front, dominated = pareto_front(scored)
    result = ParetoFront(front, dominated, space_key=key,
                         n_scored=len(scored))
    if use_cache:
        _cache.store(key, result, cache_dir)
    return result


def generate_best(spec, objective: str = "energy", device=None,
                  **search_kw):
    """One point off the front, compiled on ``device``: ``search`` +
    ``best`` + ``compile`` in one call.  ``generate()`` stays the
    single-plan path; this is the multi-objective convenience next to
    it."""
    front = search(spec, **search_kw)
    return front.best(objective).compile(device=device)
