"""The readers of the program's own spans and counters, on rows made
through ``repro_torch.telemetry`` with known values: each divides the
window by its timed calls, leaves the warm-up's rows out, and reads
nothing when the rows do not match the calls one for one or the program
has no recorder."""
import sys
import time

import pytest

from portbench import harness
from repro_torch import telemetry

SPANS = {"report_schedule_ms.bulk": "bank.schedule",
         "report_latency_ms.bulk": "bank.latency",
         "admit_ms.serve": "worker.admit",
         "round_host_ms.serve": "worker.round_host",
         "dispatch_build_ms.serve": "bank.dispatch_build",
         "fused_launch_host_ms.serve": "bank_fold.launch"}
COUNTERS = ("dispatch_builds.serve", "bucket_fill_pct.serve")
READERS = tuple(SPANS) + COUNTERS


def _work(k: int) -> None:
    """What root call ``k`` records (the warm-up's is ``k = -1``: far
    larger, so that counting it would show)."""
    scale = 1000 if k < 0 else k + 1
    for name in SPANS.values():
        telemetry.span(name, 0.001 * scale)
    telemetry.count("bank.dispatch_builds", scale)
    telemetry.count("worker.rows", 3 * scale if k >= 0 else 1)
    telemetry.count("worker.bucket_rows", 4 * scale)


def _window(n_calls: int = 3, extra: bool = False) -> harness.Record:
    with telemetry.root("design.serve"):
        _work(-1)                        # a warm-up call, before the window
    calls = []
    for k in range(n_calls):
        t0 = time.perf_counter()
        with telemetry.root("design.serve"):
            _work(k)
        calls.append((t0, time.perf_counter(), 1))
        if extra and k == 0:
            with telemetry.root("design.mul"):
                pass                     # a root call no timed call holds
    return harness.Record(setup_s=0.0, calls=calls, spans=None, device=None,
                          bound_s=None)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_divides_the_window_by_its_calls(metric):
    # 1 + 2 + 3 ms over 3 calls; the warm-up's 1,000 ms left out
    assert harness.load_reader(metric)(_window()) == pytest.approx(2.0)


def test_counter_readers_divide_the_window_by_its_calls():
    rec = _window()
    assert harness.load_reader("dispatch_builds.serve")(rec) == 2.0
    # 18 requests in 24 bucket rows; the warm-up's 1 in 4,000 left out
    assert harness.load_reader("bucket_fill_pct.serve")(rec) == 75.0


@pytest.mark.parametrize("metric", READERS)
def test_rows_not_one_a_call_read_nothing(metric):
    assert harness.load_reader(metric)(_window(extra=True)) is None


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_the_recorder_reads_nothing(metric, monkeypatch):
    import repro_torch
    rec = _window()
    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    assert harness.load_reader(metric)(rec) is None
