"""The traced run's readings, from a made-up Chrome trace on the CPU."""
import pytest

from portbench import spans


def _kernel(name, ts, dur, stream, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "args": {"correlation": corr}}


def _trace():
    """Trace clock = host clock - 100 s: marks at host 100.0, 100.001
    (side stream 9) and 100.1; program work on stream 7, the benchmark's
    on stream 9."""
    base = 0.0
    ev = [_launch(base, 1), _kernel("void at::spin_kernel(long)", 5, 10, 7, 1),
          _launch(1000, 2), _kernel("void at::spin_kernel(long)", 1005, 10, 9, 2),
          _kernel("void (anonymous namespace)::bank_fold_kernel<2>(int*)",
                  2000, 1000, 7, 3),
          _kernel("void at::native::reduce_kernel<512>(x)", 3500, 500, 9, 4),
          {"ph": "X", "cat": "gpu_memcpy", "name":
           "Memcpy DtoH (Device -> Pageable)", "ts": 50000, "dur": 2000,
           "args": {"stream": 7, "correlation": 5}},
          _launch(100000, 6),
          _kernel("void at::spin_kernel(long)", 100005, 10, 7, 6)]
    return ev


def _device():
    dev = spans.DeviceTrace(side_stream=None)
    dev._host_marks = [100.0, 100.001, 100.1]
    dev._read(_trace())
    return dev


def test_marks_set_the_window_and_the_clock():
    dev = _device()
    assert dev.measured and dev.side_id == 9
    assert dev.offset_s == pytest.approx(100.0)
    assert dev.start_s == pytest.approx(1015e-6)
    assert dev.end_s == pytest.approx(100005e-6)
    assert len(dev.events) == 3          # the marks are not work
    assert dev.counts["lag_ms"] == pytest.approx(0.005)


def test_busy_time_and_the_programs_share():
    dev = _device()
    assert dev.busy_s() == pytest.approx(3500e-6)
    assert dev.busy_s(program_only=True) == pytest.approx(3000e-6)
    ops = dict(dev.top_ops())
    assert ops["void bank_fold_kernel<2>"] == pytest.approx(1e-3)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(2e-3)


def test_idle_gaps_are_named_by_the_host_span_over_them():
    dev = _device()
    host = [("report", 100.005, 100.045), ("execute", 100.004, 100.049),
            ("gc", 100.053, 100.099)]
    calls = [(100.002, 100.0995, 1)]
    gaps = dev.idle_gaps(host, calls, "mul")
    assert [name for name, _ in gaps] == ["gc", "report", "harness"]
    assert gaps[0][1] == pytest.approx(0.048005)
    # the benchmark's kernel on its side stream does not end a gap
    assert gaps[1][1] == pytest.approx(0.047)


def test_host_spans_wrap_and_restore_the_entries():
    class Entry:
        @staticmethod
        def run(x):
            return x + 1

    run = Entry.run
    host = spans.HostSpans()
    host.install([(Entry, "run", "execute", True)], sync=False)
    assert Entry.run(1) == 2 and Entry.run(2) == 3
    host.remove()
    assert Entry.run is run
    assert [name for name, _, _ in host.intervals] == ["execute"] * 2
    assert host.total_s("execute") >= 0 and host.total_s("wait") == 0


def test_gc_spans_count_each_collection_once():
    import gc
    with spans.GcSpans() as gcs:
        gc.collect(0)
        gc.collect(2)
    assert [g for g, _, _ in gcs.intervals][-2:] == [0, 2]
    assert all(name == "gc" for name, _, _ in gcs.named())
    assert gcs.describe().startswith("gc collections [")
    assert gcs not in gc.callbacks


def test_the_benchmarks_work_alone_is_nothing_measured():
    dev = spans.DeviceTrace(side_stream=None)
    dev._host_marks = [100.0, 100.001, 100.1]
    dev._read([e for e in _trace() if e.get("args", {}).get("stream") != 7
               or "spin_kernel" in e["name"]])
    assert dev.events and not dev.measured


def test_no_marks_means_nothing_measured():
    dev = spans.DeviceTrace(side_stream=None)
    dev._host_marks = [1.0, 2.0, 3.0]
    dev._read([_kernel("void k<1>(int)", 0, 5, 7, 1)])
    assert not dev.measured


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::bank_fold_kernel<2>(unsigned int const*)",
     "void bank_fold_kernel<2>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("void at::native::f<1, g<2>(int)>(long, x)", "void at::native::f<1, g<2>(int)>"),
])
def test_kernel_names_lose_their_argument_lists(name, short):
    assert spans._short(name) == short


class _Driver:
    """Calls that take no time but advance a fake clock by 1 s each."""

    def __init__(self, clock):
        self.clock = clock
        self.kept = []

    def call(self, k):
        self.clock[0] += 1.0
        return k, 1

    def keep(self, k, out):
        self.kept.append(k)


def test_a_traced_window_runs_as_stretches(monkeypatch):
    from portbench import harness
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    sizes = []

    def stretch(calls):
        import contextlib

        @contextlib.contextmanager
        def block():
            first = len(calls)
            yield
            sizes.append(len(calls) - first)
        return block()

    calls = harness.measure(_Driver(clock), 9.5, 2, parts=3,
                            stretch=stretch)
    assert len(calls) == 10 and sizes == [4, 3, 3]
    assert harness.stretches(10 * harness.STRETCH_S) == 10
    assert harness.stretches(0.3 * harness.STRETCH_S) == 1


def test_a_blind_session_is_left_out_with_its_calls(monkeypatch):
    traces = [_trace(), [], _trace()]  # the second session recorded nothing

    def start(self):
        self._host_marks = [100.0, 100.001, 100.1]

    def stop(self):
        self._read(traces.pop(0))

    monkeypatch.setattr(spans.DeviceTrace, "start", start)
    monkeypatch.setattr(spans.DeviceTrace, "stop", stop)
    window = spans.DeviceWindow(side_stream=None)
    calls = []
    for n in (2, 5, 3):
        with window.stretch(calls):
            calls.extend([(0.0, 0.0, 1)] * n)
    assert window.measured and len(window.parts) == 2
    assert window.n_calls == 5
    assert window.busy_s(program_only=True) == pytest.approx(6000e-6)
    assert window.window_s == pytest.approx(2 * (100005 - 1015) * 1e-6)
    ops = dict(window.top_ops())
    assert ops["void bank_fold_kernel<2>"] == pytest.approx(2e-3)
    assert window.describe().startswith("device trace: 2 of 3 sessions")
    assert "; events 0, runtime 0, device 0, marks 0, lag_ms None;" \
        in window.describe()


def test_a_window_with_no_session_measured_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans.DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(spans.DeviceTrace, "stop",
                        lambda self: self._read([]))
    window = spans.DeviceWindow(side_stream=None)
    with window.stretch([]):
        pass
    assert not window.measured and window.n_calls == 0
