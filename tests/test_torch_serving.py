"""repro_torch.serving and CompiledDesign.serve, held against the reference.

Parity: the same synthesized requests go through the reference's
``Worker`` and the port's (on ``device="cpu"``); the ``responses`` dicts
must be equal, products included, and every ``ServingReport`` field but
``wall_s`` (host time) must be equal -- at one and two replicas, with
and without stealing, under a skewed router and with an ``Autoscaler``
on a diurnal trace.  The reference's designs are built by its
``generate()`` with its jaxpr dataflow gate patched out (the jax of some
environments cannot complete it).  Then port copies of
``test_serving.py`` (without the ``ServeEngine`` and lint cases); the
copies of ``test_slo_properties.py`` are in
``test_torch_slo_properties.py``.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

import repro.autotune as RA
import repro.serving as RS
import repro.verify as RV
from repro.core.bank import schedule as RSched
from repro.designs import compile as RC
from repro_torch import autotune, designs, serving
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank
from repro_torch.core.bank import schedule as S
from repro_torch.serving import (Autoscaler, SLOScheduler, Worker, admissible,
                                 bursty_arrivals, diurnal_arrivals,
                                 earliest_completion, edf_schedule,
                                 poisson_arrivals, synthesize)

#: a pure folded point, the paper's fractional-TP mixed bank, and the
#: wide CT combination
POINTS = ("tbl8_w32_relaxed", "tp3p5_w32", "tp5over6_w128")


def _cpu(name_or_spec):
    return designs.generate(name_or_spec, device="cpu")


def _requests(pkg, design, load, n, seed, budget_mult=32):
    tp = float(design.plan.throughput)
    budget = max(8, int(budget_mult / tp))
    arr = pkg.poisson_arrivals(n, load * tp, seed=seed)
    return pkg.synthesize(arr, design.spec.bits_a, design.spec.bits_b,
                          budget=budget, seed=seed + 1)


def _report(rep):
    d = dataclasses.asdict(rep)
    d.pop("wall_s")
    return d


def _responses(resp):
    return {rid: dataclasses.asdict(r) for rid, r in resp.items()}


@pytest.fixture
def ref_design(monkeypatch):
    """The reference's generate(), its dataflow gate patched out."""
    monkeypatch.setattr(RV, "assert_plan_dataflow", lambda *a, **k: None)
    return RC.generate


def _same_run(ref, port, ref_reqs, reqs, scaler=None, **kw):
    """Serve both (``scaler``: Autoscaler arguments); return the port's
    (report, responses) after holding them equal to the reference's."""
    assert [dataclasses.asdict(r) for r in reqs] == \
        [dataclasses.asdict(r) for r in ref_reqs]
    r_rep, r_resp = ref.serve(
        ref_reqs, autoscaler=scaler and RS.Autoscaler(**scaler), **kw)
    rep, resp = port.serve(
        reqs, autoscaler=scaler and Autoscaler(**scaler), **kw)
    assert _responses(resp) == _responses(r_resp)
    assert _report(rep) == _report(r_rep)
    assert rep.latency_p50 == r_rep.latency_p50
    assert rep.latency_p99 == r_rep.latency_p99
    return rep, resp


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("replicas", (1, 2))
@pytest.mark.parametrize("name", POINTS)
def test_serving_equals_reference(name, replicas, ref_design):
    ref, port = ref_design(name), _cpu(name)
    reqs = _requests(serving, port, 0.9, 48, seed=11)
    ref_reqs = _requests(RS, ref, 0.9, 48, seed=11)
    rep, resp = _same_run(ref, port, ref_reqs, reqs, replicas=replicas,
                          check=True)
    assert rep.bit_exact is True and rep.n_mismatch == 0
    assert rep.n_requests == len(resp) == 48


@pytest.mark.parametrize("name", POINTS)
def test_overload_refusals_equal_reference(name, ref_design):
    ref, port = ref_design(name), _cpu(name)
    reqs = _requests(serving, port, 2.5, 64, seed=13, budget_mult=24)
    ref_reqs = _requests(RS, ref, 2.5, 64, seed=13, budget_mult=24)
    rep, _ = _same_run(ref, port, ref_reqs, reqs, check=True)
    assert rep.n_refused > 0 and rep.slo_violations == 0


@pytest.mark.parametrize("steal", (True, False))
def test_skewed_router_stealing_equals_reference(steal, ref_design):
    ref, port = ref_design("tp3p5_w32"), _cpu("tp3p5_w32")
    tp = float(port.plan.throughput)

    def skewed(pkg):
        arr = pkg.bursty_arrivals(80, 1.2 * tp, seed=19, burst=8)
        reqs = pkg.synthesize(arr, 32, 32, budget=24, seed=20)
        return tuple(dataclasses.replace(r, rid=2 * r.rid) for r in reqs)

    rep, _ = _same_run(ref, port, skewed(RS), skewed(serving), replicas=2,
                       steal=steal, check=True)
    assert (rep.steals > 0) == steal


def test_autoscaler_diurnal_equals_reference(ref_design):
    ref, port = ref_design("tbl8_w32_relaxed"), _cpu("tbl8_w32_relaxed")
    tp = float(port.plan.throughput)

    def reqs(pkg):
        arr = pkg.diurnal_arrivals(120, 1.2 * tp, seed=29, period=128)
        return pkg.synthesize(arr, 32, 32, budget=256, seed=30)

    rep, _ = _same_run(ref, port, reqs(RS), reqs(serving),
                       scaler=dict(provisioned_tp=port.plan.throughput,
                                   max_replicas=4, ema=0.6, patience=2),
                       check=True)
    assert max(n for _, n in rep.replica_timeline) > 1


def test_signed_and_width_classes_equal_reference(ref_design):
    spec = dataclasses.replace(designs.get("tp3p5_w32"), signed=True)
    from repro.designs import DesignSpec as RSpec
    ref = ref_design(RSpec.from_json(spec.to_json()))
    port = _cpu(spec)

    def reqs(pkg):
        arr = pkg.bursty_arrivals(60, 1.1 * 3.5, seed=5, burst=5)
        return pkg.synthesize(arr, 32, 32, budget=100, seed=6,
                              width_classes=((32, 32), (16, 24), (8, 8)))

    rep, resp = _same_run(ref, port, reqs(RS), reqs(serving), replicas=2,
                          check=True)
    assert rep.bit_exact is True
    assert any(r.product[-1] & 0x8000 for r in resp.values() if r.admitted)


def test_autoscaler_recommend_equals_reference():
    ref_front = RA.search("tp3p5_w32", use_cache=False)
    front = autotune.search("tp3p5_w32", use_cache=False)
    for rate in (0.05, 0.6, 1.7, 3.2):
        a, r = Autoscaler(Fraction(7, 2), ema=1.0), \
            RS.Autoscaler(Fraction(7, 2), ema=1.0)
        a.observe(16, int(rate * 16), 16, live=1)
        r.observe(16, int(rate * 16), 16, live=1)
        got, want = a.recommend(front), r.recommend(ref_front)
        assert (got and got.to_dict()) == (want and want.to_dict())


def test_each_package_registers_its_own_slo_edf():
    assert S.SCHEDULERS["slo_edf"] is serving.SLO_SCHEDULER
    assert RSched.SCHEDULERS["slo_edf"] is RS.SLO_SCHEDULER
    assert type(S.SCHEDULERS["slo_edf"]).__module__ == \
        "repro_torch.serving.slo"
    assert type(RSched.SCHEDULERS["slo_edf"]).__module__ == \
        "repro.serving.slo"


def test_slo_edf_design_compiles_and_serves():
    spec = dataclasses.replace(designs.get("tp3p5_w32"),
                               scheduler="slo_edf")
    d = _cpu(spec)
    assert d.bank.scheduler is serving.SLO_SCHEDULER
    rep, _ = d.serve(_requests(serving, d, 0.7, 24, seed=3), check=True)
    assert rep.bit_exact is True


def test_replica_banks_live_on_the_design_device():
    w = Worker(_cpu("tp3p5_w32"), replicas=2)
    assert all(r.bank.device.type == "cpu" for r in w.replicas)


# ------------------------------------------ port copies of test_serving

def test_slo_edf_registered_and_contract_clean():
    from repro_torch.verify import contracts
    assert "slo_edf" in S.SCHEDULERS
    for cts, n_ops in contracts.SCHEDULER_CASES:
        assert not list(contracts.check_scheduler(
            S.SCHEDULERS["slo_edf"], cts, n_ops))
    assert contracts.check_all_schedulers() == []


def test_slo_default_reduces_to_greedy():
    for cts in [(1,), (2, 3), (1, 1, 2), (1, 2, 3, 4)]:
        for n in (0, 1, 7, 23):
            assert SLOScheduler().schedule(cts, n) == \
                S.greedy_schedule(cts, n)


def test_edf_orders_by_deadline():
    assign, makespan = edf_schedule((2,), 2, (0, 0), (100, 4))
    assert assign == ((1, 0),)
    assert makespan == 4
    with pytest.raises(ValueError):
        edf_schedule((2,), 3, (0, 0, 0), (1, 2))


def test_admission_predicates():
    cts, free = (1, 2), [5, 0]
    assert earliest_completion(cts, free, 3) == 5
    assert admissible(cts, free, 3, 5)
    assert not admissible(cts, free, 3, 4)


def test_completion_cycles_matches_schedule_makespan():
    cts = (1, 2, 3)
    for n in (0, 1, 5, 17):
        assign, makespan = S.greedy_schedule(cts, n)
        finish = S.completion_cycles(cts, assign)
        assert len(finish) == n
        assert (max(finish) if n else 0) == makespan


def test_histogram_percentiles():
    hist = S.latency_histogram([3, 1, 1, 7])
    assert hist == ((1, 2), (3, 1), (7, 1))
    assert S.histogram_percentile(hist, 0.5) == 1
    assert S.histogram_percentile(hist, 0.75) == 3
    assert S.histogram_percentile(hist, 0.99) == 7
    assert S.histogram_percentile((), 0.5) is None
    with pytest.raises(ValueError):
        S.histogram_percentile(hist, 1.5)


def test_bank_report_latency_hist():
    design = _cpu("tbl8_w32_relaxed")
    rep = design.report(8)
    assert sum(c for _, c in rep.latency_hist) == 8
    assert rep.latency_p50 is not None
    assert rep.latency_p99 >= rep.latency_p50
    trace = (0, 0, 4, 4, 9)
    rep2 = design.replay(trace)
    assert sum(c for _, c in rep2.latency_hist) == len(trace)


@pytest.mark.parametrize("name", POINTS)
def test_serve_below_tp_zero_violations_bit_exact(name):
    design = _cpu(name)
    reqs = _requests(serving, design, 0.7, 40, seed=11)
    rep, resp = design.serve(reqs, check=True)
    assert rep.n_requests == 40
    assert len(resp) == 40
    assert rep.slo_violations == 0
    assert rep.n_refused == 0
    assert rep.bit_exact is True
    assert all(r.met_deadline for r in resp.values())
    assert all(r.earliest_possible <= r.deadline for r in resp.values())
    assert all(r.arrival <= r.issue < r.finish for r in resp.values())


def test_serve_overload_refuses_with_evidence():
    design = _cpu("tp3p5_w32")
    reqs = _requests(serving, design, 2.5, 120, seed=13, budget_mult=24)
    rep, resp = design.serve(reqs, check=True)
    assert rep.slo_violations == 0
    assert rep.n_refused > 0
    assert rep.bit_exact is True
    refused = [r for r in resp.values() if not r.admitted]
    assert all(r.earliest_possible > r.deadline for r in refused)
    assert rep.goodput >= 0.6 * float(Fraction(rep.provisioned_tp))


def test_serve_is_deterministic():
    design = _cpu("tbl8_w32_relaxed")
    reqs = _requests(serving, design, 0.9, 40, seed=17)
    rep1, resp1 = design.serve(reqs, replicas=2)
    rep2, resp2 = design.serve(reqs, replicas=2)
    assert resp1 == resp2
    assert rep1.latency_hist == rep2.latency_hist
    assert rep1.steals == rep2.steals


def test_work_stealing_under_skewed_router():
    design = _cpu("tp3p5_w32")
    tp = float(design.plan.throughput)
    arr = bursty_arrivals(80, 1.2 * tp, seed=19, burst=8)
    reqs = synthesize(arr, 32, 32, budget=24, seed=20)
    skewed = tuple(dataclasses.replace(r, rid=2 * r.rid) for r in reqs)
    rep, resp = design.serve(skewed, replicas=2, check=True)
    assert rep.steals > 0
    assert any(r.stolen and r.replica == 1 for r in resp.values())
    assert rep.slo_violations == 0
    assert rep.bit_exact is True
    rep_ns, _ = design.serve(skewed, replicas=2, steal=False)
    assert rep.n_completed >= rep_ns.n_completed


def test_round_batches_bucketed_power_of_two():
    from repro_torch.serving.worker import _bucket
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    design = _cpu("tbl8_w32_relaxed")
    w = Worker(design)
    w.run(_requests(serving, design, 0.8, 50, seed=23))
    for rep in w.replicas:
        assert all(s & (s - 1) == 0 for s in rep.bank._compiled)


def test_fused_round_is_one_launch():
    design = _cpu("tp3p5_w32")
    bank = Bank(design.plan, 32, 32, backend="fused", device="cpu")
    assert bank.launch_count(16) == 1


def test_autoscaler_up_immediate_down_patient():
    a = Autoscaler(Fraction(1, 2), max_replicas=4, ema=1.0, patience=2)
    assert a.observe(16, 19, 16, live=1) == 3
    assert a.observe(32, 1, 16, live=3) == 3
    assert a.observe(48, 1, 16, live=3) == 1


def test_autoscaler_worker_scales_on_diurnal_trace():
    design = _cpu("tbl8_w32_relaxed")
    tp = float(design.plan.throughput)
    scaler = Autoscaler(design.plan.throughput, max_replicas=4,
                        ema=0.6, patience=2)
    arr = diurnal_arrivals(120, 1.2 * tp, seed=29, period=128)
    reqs = synthesize(arr, 32, 32, budget=256, seed=30)
    rep, _ = design.serve(reqs, autoscaler=scaler, check=True)
    assert max(n for _, n in rep.replica_timeline) > 1
    assert rep.slo_violations == 0
    assert rep.bit_exact is True


def test_autoscaler_recommends_from_pareto_front():
    from repro_torch.autotune.pareto import Candidate, ParetoFront
    from repro_torch.core.mcim import MCIMConfig

    def cand(tp, area):
        return Candidate(
            spec=designs.DesignSpec(32, 32, Fraction(tp)),
            configs=((1, MCIMConfig(arch="fb", ct=2)),),
            area_um2=area, latency_cycles=2, fmax_ghz=1.0,
            energy_per_op_pj=1.0, peak_power_mw=1.0, slack_ns=(0.0,))

    front = ParetoFront([cand("1/2", 100.0), cand("7/2", 900.0)])
    a = Autoscaler(Fraction(7, 2), ema=1.0)
    a.observe(16, 4, 16, live=1)
    rec = a.recommend(front)
    assert rec is not None
    assert rec.spec.throughput == Fraction(1, 2)
    assert front.best_meeting(10.0) is None
    with pytest.raises(ValueError):
        front.best_meeting(0.1, objective="nope")
    a.rate = 3.6
    assert a.recommend(front) is None


def test_synthesize_validates():
    with pytest.raises(ValueError):
        synthesize((3, 1), 32, 32, budget=8)
    with pytest.raises(ValueError):
        synthesize((0, 1), 32, 32, budget=0)
    with pytest.raises(ValueError):
        synthesize((0,), 32, 32, budget=8, width_classes=((64, 32),))
    reqs = synthesize((0, 0, 5), 32, 32, budget=8,
                      width_classes=((32, 32), (16, 8)))
    assert [r.tenant for r in reqs] == [0, 1, 0]
    assert all(r.deadline == r.arrival + 8 for r in reqs)
    narrow = reqs[1]
    assert L.from_limbs(np.asarray(narrow.a, np.uint32)) < 1 << 16
    assert len(narrow.a) == L.n_limbs_for_bits(32)


@pytest.mark.parametrize("shape", ("poisson", "bursty", "diurnal"))
def test_arrival_traces_equal_reference(shape):
    fn, rfn = getattr(serving, f"{shape}_arrivals"), \
        getattr(RS, f"{shape}_arrivals")
    for seed in range(3):
        assert fn(200, 0.8, seed=seed) == rfn(200, 0.8, seed=seed)
