"""The window's bookkeeping does not grow with its calls: the ``mul``
driver keeps one outcome a slot and still counts every wrong call, a
traced window's stretches end at a count of calls, and the program's rows
are read stretch by stretch, so that a window longer than the program's
ring still reads them all.  On the CPU, at a small size."""
import collections
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import harness
from repro_torch import telemetry

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: a small size of each driver's mix, by the mix's ``entry``
SMALL = {"mul": {"batch": 2048, "pool_bytes": 40_000, "sample_rows": 64},
         "serve": {"requests": 40, "traces": 2}}
SEED = 2**33 + 5


def _entry(cell) -> str:
    return harness.resolve(BENCH, cell)[2]["entry"]


BULK = [c for c in CELLS if _entry(c) == "mul"]


def _driver(cell):
    _, config, mix = harness.resolve(BENCH, cell)
    mix = {**mix, **SMALL["mul"]}
    return harness.load_driver("mul")(config, mix, SEED, torch.device("cpu"),
                                      lambda name: None)


def _tensors(obj, seen=None) -> dict:
    """Every tensor and array the driver holds outside the program:
    ``{id: (shape, dtype)}``."""
    seen = {} if seen is None else seen
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        seen[id(obj)] = (tuple(obj.shape), obj.dtype)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, seen)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, seen)
    elif dataclasses.is_dataclass(obj):
        _tensors(vars(obj), seen)
    return seen


def _held(driver) -> dict:
    return _tensors([v for k, v in vars(driver).items() if k != "design"])


def _drive(driver, n, first=0, plant=None):
    """``n`` calls and keeps from call ``first`` on; ``plant(k, out)``
    may alter a call's products before they are kept."""
    for k in range(first, first + n):
        out, _ = driver.call(k)
        if plant is not None:
            out = plant(k, out.clone())
        driver.keep(k, out)


@pytest.mark.parametrize("cell", BULK)
def test_the_mul_drivers_kept_state_does_not_grow(cell):
    driver = _driver(cell)
    _drive(driver, 8)
    after_8 = _held(driver)
    assert after_8
    _drive(driver, 56, first=8)
    assert _held(driver) == after_8
    assert [len(seen) for seen in driver.outcomes] == [1] * driver.slots
    assert sum(o.calls for seen in driver.outcomes for o in seen) == 64
    checks, attempted, failed = driver.check()
    assert failed == 0 and attempted == 64 * driver.batch
    assert all(v == 0 for v, _ in checks.values())


def _altered(row):
    """A plant that adds 1 to limb 0 of product ``row``."""
    def alter(out):
        out[row, 0] = (out[row, 0] + 1) & 0xFFFF
        return out
    return alter


@pytest.mark.parametrize("when", ["slot's first call", "a later call"])
@pytest.mark.parametrize("found_by", ["sample", "fingerprint alone"])
def test_a_fault_in_one_call_among_many_is_counted(found_by, when):
    driver = _driver("tp3p5_w32.bulk")
    assert driver.slots >= 2
    bad_k = 1 if when == "slot's first call" else 1 + 7 * driver.slots
    s = bad_k % driver.slots
    sampled = driver.rows[s].tolist()
    if found_by == "sample":
        row, rows_wrong = sampled[0], sampled.count(sampled[0])
    else:
        row = next(r for r in range(driver.batch) if r not in sampled)
        rows_wrong = 1               # found by the fingerprint alone
    alter = _altered(row)
    _drive(driver, 40, plant=lambda k, out: alter(out) if k == bad_k
           else out)
    checks, attempted, failed = driver.check()
    assert checks["calls_fingerprint_differs"][0] == 1
    assert checks["sampled_products_wrong"][0] == rows_wrong
    assert checks["products_missing"][0] == 0
    assert failed == rows_wrong and attempted == 40 * driver.batch


def test_sampled_rows_are_compared_exactly_not_by_their_fingerprint(
        monkeypatch):
    """With a fingerprint that never changes, a call whose sampled rows
    differ from its slot's first call's is still an outcome of its own."""
    from portbench.drivers import mul
    monkeypatch.setattr(mul, "fingerprint", lambda out, weights:
                        torch.zeros((), dtype=torch.int64))
    driver = _driver("tp3p5_w32.bulk")
    bad_k = 1 + 5 * driver.slots
    sampled = driver.rows[bad_k % driver.slots].tolist()
    alter = _altered(sampled[0])
    _drive(driver, 30, plant=lambda k, out: alter(out) if k == bad_k
           else out)
    checks, _, failed = driver.check()
    assert checks["sampled_products_wrong"][0] == \
        sampled.count(sampled[0]) == failed
    assert checks["calls_fingerprint_differs"][0] == 0


def test_calls_that_all_differ_are_all_counted_and_keep_a_bounded_state():
    from portbench.drivers import mul
    driver = _driver("tp3p5_w32.bulk")
    n = mul.MAX_SAMPLES + 3 * driver.slots + 5
    _drive(driver, n, plant=lambda k, out: _altered(k)(out))
    kept = [o for seen in driver.outcomes for o in seen]
    assert len(kept) == n
    assert sum(o.sample is not None for o in kept) == \
        mul.MAX_SAMPLES + driver.slots
    checks, _, failed = driver.check()
    assert checks["calls_fingerprint_differs"][0] == n
    assert checks["sampled_products_wrong"][0] >= n and failed >= n


def test_a_call_of_another_shape_counts_its_batch_missing():
    driver = _driver("tp3p5_w32.bulk")
    _drive(driver, 6, plant=lambda k, out: out[:-1] if k == 4 else out)
    checks, attempted, failed = driver.check()
    assert checks["products_missing"][0] == driver.batch
    assert checks["calls_fingerprint_differs"][0] == 0
    assert failed == driver.batch and attempted == 6 * driver.batch


@pytest.mark.parametrize("cell", BULK)
def test_the_control_is_not_correct_in_every_call(cell):
    driver = _driver(cell)
    with driver.control():
        _drive(driver, 6)
    checks, _, failed = driver.check()
    assert failed > 0 and checks["calls_fingerprint_differs"][0] == 6
    assert [len(seen) for seen in driver.outcomes] == [1] * driver.slots


class _Clock:
    """Calls that take 1 s of a fake clock each."""

    def __init__(self, clock):
        self.clock = clock

    def call(self, k):
        self.clock[0] += 1.0
        return k, 1

    def keep(self, k, out):
        pass


@pytest.mark.parametrize("seconds, parts, max_calls, sizes", [
    (10, 2, 3, [3, 2, 3, 2]),
    (9.5, 3, 100, [4, 3, 3]),
    (12, 1, 5, [5, 5, 2]),
    (3, 4, 1, [1, 1, 1]),
])
def test_measure_ends_a_stretch_at_its_share_or_its_calls(
        seconds, parts, max_calls, sizes, monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    cuts = []

    @contextlib.contextmanager
    def stretch(calls):
        first = len(calls)
        yield
        cuts.append((first, len(calls)))

    calls = harness.measure(_Clock(clock), seconds, 0, parts, stretch,
                            max_calls)
    assert [b - a for a, b in cuts] == sizes
    # every call in exactly one stretch, in order
    assert cuts[0][0] == 0 and cuts[-1][1] == len(calls)
    assert all(b == a for (_, b), (a, _) in zip(cuts, cuts[1:]))
    assert len(calls) == -(-seconds // 1)


def _program_readers(cell) -> list:
    """The cell's per-layer readers that read the program's rows."""
    return [m["name"] for m in harness.cell_metrics(BENCH, cell, "per_layer")
            if "program_spans" in (harness.ROOT / "metrics" /
                                   f"{m['name']}.py").read_text()]


def _traced(cell, monkeypatch, ring=1, stretch_calls=1):
    """A traced run of 1 s on a ring of ``ring`` rows, in stretches of at
    most ``stretch_calls`` calls (bulk calls of 256 products)."""
    monkeypatch.setattr(telemetry, "_ring",
                        collections.deque(maxlen=ring))
    monkeypatch.setattr(harness, "STRETCH_CALLS", stretch_calls)
    mix = SMALL[_entry(cell)]
    if "batch" in mix:
        mix = {**mix, "batch": 256}
    return harness.run_cell(BENCH, cell, SEED, 1.0, True,
                            t_start=time.perf_counter(), device="cpu",
                            mix_override=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_rows_read_stretch_by_stretch_outlast_the_ring(cell, monkeypatch):
    res = _traced(cell, monkeypatch)
    rec = res["record"]
    assert rec.n_calls > 1 and rec.program.n_calls == rec.n_calls
    values = dict((m["name"], v) for m, v in res["metrics"])
    names = _program_readers(cell)
    assert names and all(values[n] is not None for n in names)
    # read at once after the window, the ring holds too few rows
    whole = dataclasses.replace(rec, program=None)
    assert all(harness.load_reader(n)(whole) is None for n in names)


@pytest.mark.parametrize("cell", ["tp3p5_w32.bulk", "tp3p5_w32.serve"])
def test_a_stretch_that_loses_a_row_reads_nothing(cell, monkeypatch):
    calls = telemetry.calls
    read = []

    def lossy(t0, t1):
        rows = calls(t0, t1)
        read.append(len(rows))
        return rows[1:] if len(read) == 2 else rows

    monkeypatch.setattr(telemetry, "calls", lossy)
    res = _traced(cell, monkeypatch, ring=100)
    assert len(read) >= 2 and res["record"].program.unmatched == 1
    values = dict((m["name"], v) for m, v in res["metrics"])
    assert all(values[n] is None for n in _program_readers(cell))


class _KinetoEvent:
    """The profiler's own event of one Chrome trace event (times in ns
    from a base)."""

    def __init__(self, e, base_ns):
        self.e, self.base_ns = e, base_ns

    def device_type(self):
        return torch.autograd.DeviceType.CPU if \
            self.e["cat"] in ("cuda_runtime", "overhead") else \
            torch.autograd.DeviceType.CUDA

    def name(self):
        return self.e["name"]

    def correlation_id(self):
        return self.e["args"]["correlation"]

    def device_resource_id(self):
        return self.e["args"].get("stream", 4242)

    def start_ns(self):
        return self.base_ns + round(self.e["ts"] * 1000)

    def duration_ns(self):
        return round(self.e["dur"] * 1000)


def test_the_profilers_own_events_read_as_its_trace():
    from types import SimpleNamespace

    from portbench import spans
    from portbench.test_portbench_spans import _trace
    base = 1_792_000_000_000_000_000
    # the profiler's own host event, sharing a launch's correlation
    other = {"ph": "X", "cat": "overhead", "name": "Lazy Function Loading",
             "ts": 7, "dur": 1, "args": {"correlation": 1}}
    result = SimpleNamespace(
        trace_start_ns=lambda: base,
        events=lambda: [_KinetoEvent(e, base) for e in _trace() + [other]])
    got, want = (spans.DeviceTrace(side_stream=None) for _ in range(2))
    for dev in (got, want):
        dev._host_marks = [100.0, 100.001, 100.1]
    got._take(*spans.profiled(result))
    want._read(_trace())
    assert got.counts.pop("events") == want.counts.pop("events") + 1
    assert got.counts == want.counts
    assert (got.side_id, got.start_s, got.end_s) == \
        (want.side_id, want.start_s, want.end_s)
    assert got.offset_s == pytest.approx(want.offset_s)
    assert got.events == want.events


def test_sessions_are_sized_by_the_last_ones_events(monkeypatch):
    """The first session takes FIRST_SESSION_CALLS calls; each next one as
    many as SESSION_EVENTS at the last one's events a call, at most
    SESSION_CALLS; ``measure`` asks before each stretch."""
    from portbench import spans
    per_call = [500, 5, 5, 5]           # events a call, session by session
    state = {}

    def start(self):
        state["first"] = len(state["calls"])

    def stop(self):
        n = len(state["calls"]) - state["first"]
        self.counts = {"events": per_call[len(sizes)] * n}

    monkeypatch.setattr(spans.DeviceTrace, "start", start)
    monkeypatch.setattr(spans.DeviceTrace, "stop", stop)
    window = spans.DeviceWindow(side_stream=None)
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    sizes = []

    @contextlib.contextmanager
    def stretch(calls):
        state["calls"] = calls
        first = len(calls)
        with window.stretch(calls):
            yield
        sizes.append(len(calls) - first)

    calls = harness.measure(_Clock(clock), 1000, 0, 1, stretch,
                            window.max_calls)
    first, cap = spans.FIRST_SESSION_CALLS, spans.SESSION_EVENTS // 500
    assert sizes == [first, cap, spans.SESSION_CALLS,
                     1000 - first - cap - spans.SESSION_CALLS]
    assert sum(sizes) == len(calls) == 1000
