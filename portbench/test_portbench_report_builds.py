"""The reader of ``report_builds.bulk`` on rows made through
``repro_torch.telemetry`` with known values: it divides the window's
``bank.report_builds`` by the timed calls, leaves the warm-up's rows out,
and reads nothing when the rows do not match the calls one for one, the
program has no recorder, or the recorder has no such counter (a program
from before the report cache)."""
import dataclasses
import sys
import time

from portbench import harness
from repro_torch import telemetry

METRIC = "report_builds.bulk"


def _window(n_calls: int = 3, extra: bool = False) -> harness.Record:
    """A warm-up call that builds 1,000 reports, then ``n_calls`` timed
    calls that build 1, 2, 3, ...; ``extra`` puts a root call no timed
    call holds into the window."""
    with telemetry.root("design.mul"):
        telemetry.count("bank.report_builds", 1000)
    calls = []
    for k in range(n_calls):
        t0 = time.perf_counter()
        with telemetry.root("design.mul"):
            telemetry.count("bank.report_builds", k + 1)
        calls.append((t0, time.perf_counter(), 1))
        if extra and k == 0:
            with telemetry.root("design.mul"):
                pass
    return harness.Record(setup_s=0.0, calls=calls, spans=None, device=None,
                          bound_s=None)


def test_the_reader_divides_the_window_by_its_calls():
    # 1 + 2 + 3 builds over 3 calls; the warm-up's 1,000 left out
    assert harness.load_reader(METRIC)(_window()) == 2.0


def test_rows_not_one_a_call_read_nothing():
    assert harness.load_reader(METRIC)(_window(extra=True)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import repro_torch
    rec = _window()
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    assert harness.load_reader(METRIC)(rec) is None


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    """Rows whose counters lack ``bank.report_builds`` read ``None``,
    not 0."""
    rec = _window()
    calls = telemetry.calls

    def without(t0, t1):
        return [dataclasses.replace(c, counters={
                    k: v for k, v in c.counters.items()
                    if k != "bank.report_builds"})
                for c in calls(t0, t1)]

    monkeypatch.setattr(telemetry, "calls", without)
    assert harness.load_reader(METRIC)(rec) is None
