"""``Bank.report``'s cache: the report under the bank's own policy is
built once per batch size and the same frozen object handed back after;
it equals a fresh build field for field under every registered policy,
the oldest size is evicted past ``MAX_COMPILED``, an explicit
``scheduler`` bypasses it, ``bank.report_builds`` counts the builds, and
``Bank.execute`` asks for one report a call."""
import dataclasses

import numpy as np
import pytest

import repro_torch.serving  # noqa: F401  (registers slo_edf)
from repro_torch import designs, telemetry
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank, BankReport

SCHEDULERS = ("round_robin", "greedy", "streaming", "slo_edf")
BATCHES = (0, 1, 97, 4096)


@pytest.fixture(scope="module")
def plan():
    # tp3p5_w32: 3 star(ct=1) + 1 fb(ct=2), so the policies differ
    return designs.generate("tp3p5_w32", device="cpu").plan


def _bank(plan, scheduler="round_robin") -> Bank:
    return Bank(plan, 32, 32, scheduler=scheduler, device="cpu")


def _fields(rep: BankReport) -> dict:
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}


def _builds() -> int:
    return telemetry.totals()["counters"]["bank.report_builds"]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_cached_report_is_a_fresh_report(plan, scheduler, batch):
    bank = _bank(plan, scheduler)
    rep = bank.report(batch)
    assert bank.report(batch) is rep
    fresh = _bank(plan, scheduler)
    # a fresh bank's cached build and an uncached build, field for field
    assert _fields(rep) == _fields(fresh.report(batch)) \
        == _fields(fresh.report(batch, scheduler=scheduler))
    assert rep.scheduler == scheduler and rep.batch == batch
    assert sum(i.n_ops for i in rep.instances) == batch


def test_the_oldest_size_is_evicted_and_rebuilt_equal(plan):
    bank = _bank(plan)
    sizes = range(1, Bank.MAX_COMPILED + 2)
    first = {n: bank.report(n) for n in sizes}
    assert len(bank._reports) == Bank.MAX_COMPILED
    assert 1 not in bank._reports and 2 in bank._reports
    before = _builds()
    again = bank.report(1)                  # evicted: built anew
    assert _builds() == before + 1
    assert again is not first[1] and _fields(again) == _fields(first[1])
    assert 2 not in bank._reports           # the next oldest made room
    assert bank.report(sizes[-1]) is first[sizes[-1]]
    assert _builds() == before + 1


def test_an_explicit_scheduler_bypasses_the_cache(plan):
    bank = _bank(plan)
    batch = 97
    rr = bank.report(batch)
    want = _bank(plan, "greedy").report(batch)
    before = _builds()
    greedy = bank.report(batch, scheduler="greedy")
    assert greedy.scheduler == "greedy" and _fields(greedy) == _fields(want)
    assert _fields(greedy) != _fields(rr)
    assert bank.report(batch) is rr         # the cache still holds rr
    assert _builds() == before              # no build of the bank's own


def test_report_builds_counts_one_per_distinct_size(plan):
    bank = _bank(plan)
    before = _builds()
    for n in (5, 7, 5, 7, 9, 5):
        bank.report(n)
    assert _builds() == before + 3


def test_execute_asks_for_one_report_a_call(plan, monkeypatch):
    bank = _bank(plan)
    asked = []
    report = Bank.report

    def counted(self, batch, scheduler=None):
        asked.append(batch)
        return report(self, batch, scheduler)

    monkeypatch.setattr(Bank, "report", counted)
    rng = np.random.default_rng(0)
    a, b = (L.from_numpy(L.random_limbs(rng, (16,), 32), "cpu")
            for _ in range(2))
    seen = []
    for k in range(3):
        bank.execute(a, b)
        seen.append(bank.last_report)
    bank.execute(a[:5], b[:5])
    assert asked == [16, 16, 16, 5]
    assert seen[0] is seen[1] is seen[2] and seen[0].batch == 16
    assert bank.last_report.batch == 5
