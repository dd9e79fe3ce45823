"""Hypothesis property tests for the port's SLO scheduling and admission.

Port copies of ``test_slo_properties.py``, strategies unchanged: the
pure-scheduler properties on wide random grids, and the worker-loop
properties -- no admitted request ever misses its deadline, refusals
only when provably infeasible, bursty-trace bit-exactness vs the bigint
oracle -- on the port's compiled design on ``device="cpu"``.  The
worker-loop cases also hold each run equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest

hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core import limbs as L
from repro_torch.core.bank import schedule as S
from repro_torch.serving import slo
from repro_torch.serving.requests import (bursty_arrivals, poisson_arrivals,
                                          synthesize)

CTS = st.lists(st.integers(min_value=1, max_value=8),
               min_size=1, max_size=6).map(tuple)
N_OPS = st.integers(min_value=0, max_value=60)
SEEDS = st.integers(min_value=0, max_value=2**16)


@st.composite
def edf_cases(draw):
    cts = draw(CTS)
    n = draw(N_OPS)
    arrivals = tuple(sorted(
        draw(st.lists(st.integers(min_value=0, max_value=40),
                      min_size=n, max_size=n))))
    deadlines = tuple(a + draw(st.integers(min_value=1, max_value=60))
                      for a in arrivals)
    return cts, n, arrivals, deadlines


@settings(max_examples=200, deadline=None)
@given(case=edf_cases())
def test_edf_complete_and_duplicate_free(case):
    cts, n, arrivals, deadlines = case
    assign, makespan = slo.edf_schedule(cts, n, arrivals, deadlines)
    flat = sorted(op for ops in assign for op in ops)
    assert flat == list(range(n)), "incomplete or duplicated"
    assert len(assign) == len(cts)
    assert makespan >= 0


@settings(max_examples=200, deadline=None)
@given(case=edf_cases())
def test_edf_deterministic_and_chain_reconstructible(case):
    cts, n, arrivals, deadlines = case
    first = slo.edf_schedule(cts, n, arrivals, deadlines)
    assert slo.edf_schedule(cts, n, arrivals, deadlines) == first
    assign, makespan = first
    finish = S.completion_cycles(cts, assign, arrivals)
    assert (max(finish) if n else 0) == makespan
    for ops, ct in zip(assign, cts):
        for k in ops:
            assert finish[k] >= arrivals[k] + ct


@settings(max_examples=200, deadline=None)
@given(case=edf_cases())
def test_edf_equals_reference(case):
    from repro.serving import slo as rslo
    assert slo.edf_schedule(*case) == rslo.edf_schedule(*case)


@settings(max_examples=200, deadline=None)
@given(cts=CTS, n=N_OPS)
def test_slo_without_deadlines_is_greedy(cts, n):
    assert slo.SLOScheduler().schedule(cts, n) == S.greedy_schedule(cts, n)


@settings(max_examples=200, deadline=None)
@given(cts=CTS,
       free=st.lists(st.integers(min_value=0, max_value=50),
                     min_size=1, max_size=6),
       arrival=st.integers(min_value=0, max_value=50))
def test_earliest_completion_is_a_lower_bound(cts, free, arrival):
    free = (free * len(cts))[:len(cts)]
    best = slo.earliest_completion(cts, free, arrival)
    assert any(max(f, arrival) + ct == best
               for f, ct in zip(free, cts))
    assert all(max(f, arrival) + ct >= best
               for f, ct in zip(free, cts))
    assert best >= arrival + min(cts)


@settings(max_examples=100, deadline=None)
@given(lat=st.lists(st.integers(min_value=0, max_value=30), max_size=50),
       q1=st.floats(min_value=0.0, max_value=1.0),
       q2=st.floats(min_value=0.0, max_value=1.0))
def test_histogram_percentile_monotone(lat, q1, q2):
    hist = S.latency_histogram(lat)
    assert sum(c for _, c in hist) == len(lat)
    if not lat:
        assert S.histogram_percentile(hist, q1) is None
        return
    lo, hi = sorted((q1, q2))
    assert S.histogram_percentile(hist, lo) <= \
        S.histogram_percentile(hist, hi)
    assert S.histogram_percentile(hist, 1.0) == max(lat)


# --------------------------------------------------- worker-loop properties

@pytest.fixture(scope="module")
def design():
    from repro_torch import designs
    return designs.generate("tbl8_w32_relaxed", device="cpu")


@pytest.fixture(scope="module")
def ref_design():
    """The reference's design, built from its plan (its jaxpr dataflow
    gate is not run: the jax of some environments cannot complete it)."""
    import repro.verify
    from repro.designs import compile as RC
    real = repro.verify.assert_plan_dataflow
    repro.verify.assert_plan_dataflow = lambda *a, **k: None
    try:
        return RC.generate("tbl8_w32_relaxed")
    finally:
        repro.verify.assert_plan_dataflow = real


def _same_as_reference(ref_design, reqs, rep, resp, **kw):
    from repro.serving import Request as RRequest
    r_rep, r_resp = ref_design.serve(
        [RRequest(**dataclasses.asdict(r)) for r in reqs], **kw)
    assert {k: dataclasses.asdict(v) for k, v in resp.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_resp.items()}
    want = dataclasses.asdict(r_rep)
    got = dataclasses.asdict(rep)
    want.pop("wall_s"), got.pop("wall_s")
    assert got == want


@settings(max_examples=10, deadline=None)
@given(seed=SEEDS,
       load=st.floats(min_value=0.3, max_value=2.5),
       budget=st.integers(min_value=4, max_value=80))
def test_admissions_meet_deadline_refusals_infeasible(design, ref_design,
                                                      seed, load, budget):
    tp = float(design.plan.throughput)
    arr = poisson_arrivals(16, load * tp, seed=seed)
    reqs = synthesize(arr, 32, 32, budget=budget, seed=seed + 1)
    rep, resp = design.serve(reqs)
    assert rep.slo_violations == 0
    for r in resp.values():
        if r.admitted:
            assert r.arrival <= r.issue < r.finish <= r.deadline
            assert r.earliest_possible <= r.deadline
        else:
            assert r.earliest_possible > r.deadline
    _same_as_reference(ref_design, reqs, rep, resp)


@settings(max_examples=6, deadline=None)
@given(seed=SEEDS)
def test_bursty_trace_bit_exact_vs_oracle(design, ref_design, seed):
    tp = float(design.plan.throughput)
    arr = bursty_arrivals(20, 1.1 * tp, seed=seed, burst=5)
    reqs = synthesize(arr, 32, 32, budget=100, seed=seed + 1,
                      width_classes=((32, 32), (16, 24), (8, 8)))
    rep, resp = design.serve(reqs, replicas=2, check=True)
    assert rep.n_checked == rep.n_admitted
    assert rep.bit_exact is True
    for req in reqs:
        r = resp[req.rid]
        if r.admitted:
            assert L.from_limbs(np.asarray(r.product, np.uint32)) == \
                req.oracle()
    _same_as_reference(ref_design, reqs, rep, resp, replicas=2, check=True)
