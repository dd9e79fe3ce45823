"""Candidate enumeration: every MCIM decomposition of a DesignSpec.

``generate()`` runs the paper's pick-one policy; the autotuner instead
enumerates the whole space that policy chooses from:

  1. the fractional part of the throughput is decomposed into every
     multiset of 1/CT terms over the planner's CT set (Sec. V-B: e.g.
     5/6 = 1/2 + 1/3, 11/12 = 1/2 + 1/3 + 1/12, ...);
  2. each CT slot is filled with every architecture variant that can
     realize it -- FB, FF, and (CT=3) folded Karatsuba at recursion
     levels 1..3 with 1CA or 3CA final adders;
  3. the integer part stays Star instances (a full multiply per cycle
     has no folded realization), matching the paper's use-case banks.

Timing constraints are enforced with the SAME gate ``generate()`` uses
(``timing_model.meets_timing`` / ``pipelineable`` via the helpers in
``repro_torch.designs.compile``), not a reimplementation, so a candidate
surviving enumeration is by construction compilable by
``designs.compile_plan``.
"""
from __future__ import annotations

import itertools
import math
from fractions import Fraction

from repro_torch.core import timing_model
from repro_torch.core.mcim import MCIMConfig
from repro_torch.designs import DesignSpec, DesignError
from repro_torch.designs.compile import _instance_latency, _timing_bits

#: the planner's CT vocabulary (Sec. V-B combinations)
CT_SET = (2, 3, 4, 6, 8, 12)
#: Karatsuba recursion depths explored per CT=3 slot
KARATSUBA_LEVELS = (1, 2, 3)
#: bound on the number of folded instances per bank (11/12 needs 3)
MAX_PARTS = 6
#: safety valve on the cross-product size per spec
MAX_CANDIDATES = 4096


def ct_decompositions(frac: Fraction) -> list:
    """All multisets of CTs from CT_SET with sum(1/ct) == frac,
    as non-increasing ct tuples (canonical, duplicate-free)."""
    out = []

    def rec(remaining: Fraction, max_ct: int, parts: tuple):
        if remaining == 0:
            if parts:
                out.append(parts)
            return
        if len(parts) >= MAX_PARTS:
            return
        for ct in CT_SET:
            if ct < max_ct:          # non-increasing ct == non-decreasing 1/ct
                continue
            piece = Fraction(1, ct)
            if piece <= remaining:
                rec(remaining - piece, ct, parts + (ct,))

    rec(frac, 0, ())
    return out


def _arch_variants(bits_a: int, bits_b: int, ct: int) -> list:
    """Every MCIMConfig that realizes one 1/ct slot."""
    variants = [MCIMConfig(arch="fb", ct=ct), MCIMConfig(arch="ff", ct=ct)]
    if ct == 3:
        for levels in KARATSUBA_LEVELS:
            for adder in ("1ca", "3ca"):
                variants.append(MCIMConfig(arch="karatsuba", ct=3,
                                           levels=levels, adder=adder))
    return variants


def _meets_spec_timing(cfg: MCIMConfig, spec: DesignSpec, bits: int) -> bool:
    """The generate() timing gate, applied per candidate instance."""
    if spec.strict_timing and \
            not timing_model.pipelineable(cfg.arch, cfg.adder):
        return False
    if spec.clock_ns is not None and \
            not timing_model.meets_timing(cfg.arch, bits, spec.clock_ns,
                                          cfg.adder):
        return False
    if spec.latency_budget is not None and \
            _instance_latency(cfg, bits, spec.clock_ns) > spec.latency_budget:
        return False
    return True


def enumerate_configs(spec: DesignSpec) -> list:
    """All candidate instance lists for ``spec``, timing-gated.

    Returns a list of ``tuple[(count, MCIMConfig)]`` entries, each
    summing to exactly ``spec.throughput``; deduplicated as multisets
    and deterministically ordered.
    """
    tp = spec.throughput
    bits = _timing_bits(spec)
    n_full = math.floor(tp)
    frac = tp - n_full
    base = ((n_full, MCIMConfig(arch="star", ct=1)),) if n_full else ()
    if base and not _meets_spec_timing(base[0][1], spec, bits):
        return []                       # Star itself misses the target
    if frac == 0:
        return [base] if base else []

    seen, out = set(), []
    for cts in ct_decompositions(frac):
        pools = []
        for ct in cts:
            pool = [cfg for cfg in _arch_variants(spec.bits_a, spec.bits_b,
                                                  ct)
                    if _meets_spec_timing(cfg, spec, bits)]
            pools.append(pool)
        if any(not pool for pool in pools):
            continue                    # a slot nothing can fill in time
        for combo in itertools.product(*pools):
            multiset = tuple(sorted(
                ((cfg.arch, cfg.ct, cfg.levels, cfg.adder) for cfg in combo)))
            if multiset in seen:
                continue
            seen.add(multiset)
            counts = {}
            for cfg in combo:
                counts[cfg] = counts.get(cfg, 0) + 1
            configs = base + tuple(
                (count, cfg) for cfg, count in sorted(
                    counts.items(),
                    key=lambda kv: (kv[0].ct, kv[0].arch, kv[0].levels,
                                    kv[0].adder)))
            out.append(configs)
            if len(out) >= MAX_CANDIDATES:
                raise DesignError(
                    f"candidate space for {spec.describe()} exceeds "
                    f"{MAX_CANDIDATES}; constrain the spec (clock, "
                    f"strict_timing) to prune it")
    return out
