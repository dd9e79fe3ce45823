"""``repro_torch.telemetry``: the rows of a ``serve`` call on each of the
benchmark's designs against what the call itself reports, and the
recorder's own rules: increasing ids, nested roots, the ring's bound,
work outside a root, and a root left by an exception.

The traces are the benchmark's (``portbench/traffic/serve.json`` through
``portbench.generator.serve_traces``), one 400-request trace a design.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import generator
from repro_torch import designs, telemetry
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank
from repro_torch.serving import Request, worker

ROOT = Path(__file__).resolve().parent.parent
SERVE_MIX = json.loads((ROOT / "portbench" / "traffic" / "serve.json")
                       .read_text())
DESIGNS = ("tp3p5_w32", "tp5over6_w128")
SEED = 2**31 + 11
CHILDREN = ("bank.schedule", "bank.latency", "bank.dispatch_build",
            "bank_fold.launch", "worker.admit", "worker.round_host")


def _trace(design) -> tuple:
    spec = design.spec
    max_ct = max(cfg.ct for cfg in design.bank.instances)
    rows, = generator.serve_traces({**SERVE_MIX, "traces": 1}, spec.bits_a,
                                   spec.bits_b, float(design.plan.throughput),
                                   max_ct, SEED)
    return tuple(Request(rid=rid, arrival=t, deadline=d, a=a, b=b,
                         bits_a=spec.bits_a, bits_b=spec.bits_b)
                 for rid, t, d, a, b in rows)


@pytest.fixture(scope="module", params=DESIGNS)
def served(request):
    """One serve call: its report, its one row, the caller's interval and
    the real rows of each round (``worker._bucket``'s arguments)."""
    design = designs.generate(request.param, device="cpu")
    trace = _trace(design)
    sizes = []
    bucket = worker._bucket

    def recorded(n):
        sizes.append(n)
        return bucket(n)

    mp = pytest.MonkeyPatch()
    mp.setattr(worker, "_bucket", recorded)
    try:
        t0 = time.perf_counter()
        report, _ = design.serve(trace, replicas=1, check=True)
        t1 = time.perf_counter()
    finally:
        mp.undo()
    rows = telemetry.calls(t0, t1)
    assert len(rows) == 1
    return report, rows[0], (t0, t1), sizes


def test_serve_counters_match_the_report(served):
    report, row, _, sizes = served
    assert report.bit_exact and report.rounds > 0
    assert row.root == "design.serve" and row.spans["design.serve"] == 0
    assert row.counters["worker.rows"] == sum(sizes) == report.n_admitted
    assert row.spans["worker.round_host"] == len(sizes) == report.rounds
    buckets = [worker._bucket(n) for n in sizes]
    assert row.counters["worker.bucket_rows"] == sum(buckets)
    assert row.counters["bank.dispatch_builds"] == len(set(buckets)) \
        == row.spans["bank.dispatch_build"]
    # every round asks for its report, built once a bucket size (the
    # rest hit the bank's report cache); the plain CPU path launches no
    # kernel
    assert row.counters["bank.report_builds"] == len(set(buckets)) \
        == row.spans["bank.schedule"] == row.spans["bank.latency"]
    assert row.spans["worker.admit"] >= report.rounds
    assert row.spans["bank_fold.launch"] == 0
    assert not any(v for k, v in row.counters.items()
                   if k.startswith("launch."))


def test_serve_spans_fit_inside_their_root(served):
    _, row, (t0, t1), _ = served
    assert t0 <= row.t0 < row.t1 <= t1
    # the children are disjoint (report's two inside execute, beside the
    # build; the worker's two outside execute), so they sum within it
    assert all(row.seconds[name] > 0 for name in
               ("bank.schedule", "bank.latency", "bank.dispatch_build",
                "worker.admit", "worker.round_host"))
    assert sum(row.seconds[name] for name in CHILDREN) <= row.t1 - row.t0


def test_mul_rows_and_nested_roots():
    design = designs.generate("tp3p5_w32", device="cpu")
    rng = np.random.default_rng(0)
    a, b = (L.from_numpy(L.random_limbs(rng, (96,), 32), "cpu")
            for _ in range(2))
    t0 = time.perf_counter()
    design.mul(a, b)
    design.mul(a, b)
    assert design.mul(3, 5) == 15
    with telemetry.root("design.serve"):
        design.mul(a, b)                 # a root inside a root: a child
    t1 = time.perf_counter()
    rows = telemetry.calls(t0, t1)
    assert [r.root for r in rows] == ["design.mul"] * 3 + ["design.serve"]
    assert [r.id for r in rows] == list(range(rows[0].id, rows[0].id + 4))
    assert all(x.t1 <= y.t0 for x, y in zip(rows, rows[1:]))
    first, second, ints, outer = rows
    assert first.counters["bank.dispatch_builds"] == 1
    assert second.counters["bank.dispatch_builds"] == 0
    assert ints.counters["bank.dispatch_builds"] == 1   # batch 1
    # a report is built once a batch size: 96 on the first call, 1 on the
    # ints'; the second and the nested call hit the bank's report cache
    for r, builds in zip(rows, (1, 0, 1, 0)):
        assert r.counters["bank.report_builds"] == builds \
            == r.spans["bank.schedule"] == r.spans["bank.latency"]
    assert outer.spans["design.mul"] == 1
    assert 0 < outer.seconds["design.mul"] <= outer.t1 - outer.t0


def test_the_ring_drops_its_oldest_rows():
    t0 = time.perf_counter()
    for _ in range(3):
        with telemetry.root("design.mul"):
            pass
    t1 = time.perf_counter()
    for k in range(telemetry.CAPACITY):
        with telemetry.root("design.mul"):
            pass
        if k == 1:
            t2 = time.perf_counter()
    assert telemetry.calls(t0, t1) == []
    kept = telemetry.calls(t1, t2)
    assert len(kept) == 2 and kept[1].id == kept[0].id + 1


def test_spans_outside_a_root_reach_the_totals_only():
    bank = designs.generate("tp3p5_w32", device="cpu").bank
    a = L.from_numpy(np.ones((8, 2), np.uint32), "cpu")
    before = telemetry.totals()
    t0 = time.perf_counter()
    bank.execute(a, a)
    telemetry.count("worker.rows", 5)
    t1 = time.perf_counter()
    after = telemetry.totals()
    assert telemetry.calls(t0, t1) == []
    assert after["spans"]["bank.schedule"] == \
        before["spans"]["bank.schedule"] + 1
    assert after["seconds"]["bank.latency"] > before["seconds"]["bank.latency"]
    assert after["counters"]["bank.report_builds"] == \
        before["counters"]["bank.report_builds"] + 1
    assert after["counters"]["bank.dispatch_builds"] == \
        before["counters"]["bank.dispatch_builds"] + 1
    assert after["counters"]["worker.rows"] == \
        before["counters"]["worker.rows"] + 5
    telemetry.reset()
    zero = telemetry.totals()
    assert not any(v for part in zero.values() for v in part.values())


def test_an_exception_inside_execute_leaves_the_next_row_clean(monkeypatch):
    design = designs.generate("tp3p5_w32", device="cpu")
    a = L.from_numpy(np.ones((8, 2), np.uint32), "cpu")
    dispatch_fn = Bank.dispatch_fn

    def failing(bank, batch):
        def run(a, b):
            raise RuntimeError("planted")
        return run

    t0 = time.perf_counter()
    monkeypatch.setattr(Bank, "dispatch_fn", failing)
    with pytest.raises(RuntimeError, match="planted"):
        design.mul(a, a)
    monkeypatch.setattr(Bank, "dispatch_fn", dispatch_fn)
    design.bank._compiled.clear()
    design.mul(a, a)
    t1 = time.perf_counter()
    failed, clean = telemetry.calls(t0, t1)
    assert failed.spans["bank.dispatch_build"] == 1
    assert failed.counters["bank.report_builds"] == 1   # before the raise
    assert clean.id == failed.id + 1 and clean.root == "design.mul"
    assert clean.spans["design.mul"] == 0         # not nested in the failed
    # the report the failed call built is kept; the dispatch was cleared
    assert clean.spans["bank.schedule"] == 0
    assert clean.counters["bank.report_builds"] == 0
    assert clean.counters["bank.dispatch_builds"] == 1


def test_totals_read_and_reset_inside_an_open_root():
    """Launches counted inside a root show in the totals at once (as
    ``launch_counts()`` read them); a reset there keeps the root's row."""
    t0 = time.perf_counter()
    with telemetry.root("design.mul"):
        telemetry.count("launch.bank_fold")
        assert telemetry.totals()["counters"]["launch.bank_fold"] >= 1
        telemetry.reset()
        telemetry.count("launch.bank_fold", 2)
        assert telemetry.totals()["counters"]["launch.bank_fold"] == 2
    row, = telemetry.calls(t0, time.perf_counter())
    assert row.counters["launch.bank_fold"] == 3
    assert telemetry.totals()["counters"]["launch.bank_fold"] == 2
    assert telemetry.totals()["spans"]["design.mul"] == 1
