"""What a run records over its window, and how it is read.

Host spans (traced runs): the benchmark wraps the program's public
entries that the cell's driver names (``span_targets()``, see
``drivers/``) for the measured window only, and records each call's
interval under the driver's span name.  An entry marked to wait gets a
``torch.cuda.synchronize()`` right after it returns, recorded as
``wait``: the wait for the device work it enqueued (the caller waits
there in any case).

Garbage collections (every run): :class:`GcSpans`, the one recorder of
the interpreter's collections, read by the window's diagnostic line and
by the traced run's idle gaps (``gc``).

Device: ``torch.profiler`` with CUDA activity only, its runtime calls
and device operations read from the profiler's own events
(:func:`profiled`; no trace file).  A ``spin_kernel``
(``torch.cuda._sleep``) launched at a recorded host time on each end of
a profiled stretch ties the trace's clock to the host's and marks the
stretch; a third, on the benchmark's side stream (a stream of its own
where the driver has none), names that stream, so the benchmark's own
device work (the bulk mix's fingerprints) is told apart from the
program's and left out of every reading.

:class:`DeviceWindow` profiles the window as a few such stretches, each
a profiler session of its own started and stopped between calls: a
session whose trace lacks its marks or the program's work is left out,
with the calls it covered, and the others still read.  The harness ends
a stretch at a share of the window's time or at the count of calls
:meth:`DeviceWindow.max_calls` gives (``harness.measure``), so that a
session's trace stays as small as those that kept their marks.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import gc
import time

import torch

MARK_CYCLES = 20_000
#: the wait after a profiler session starts and before it stops (s): the
#: trace keeps only device work that its clock puts inside the session,
#: and the device's clock reads up to some milliseconds off the host's
#: (medians of -3 to +0.4 ms between a launch and its kernel in traced
#: bulk runs), so a mark launched at once can fall outside and be lost
SETTLE_S = 0.03
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the profiler events a session may hold: sessions of up to ~25,000
#: (800 bulk calls, 40 128-bit serve calls) kept their three marks in
#: every traced run, sessions of 45,000-70,000 (128-bit serve calls cut
#: by time alone, 2,800 32-bit bulk calls) lost them in about half
SESSION_EVENTS = 20_000
#: the calls of a window's first session, before any has been counted
FIRST_SESSION_CALLS = 40
#: the most calls of any session (the 381-bit bulk cell's ~1,050 calls a
#: session kept 20 of 20)
SESSION_CALLS = 800


class HostSpans:
    """Interval recorder around the program's public entries."""

    def __init__(self):
        self.intervals = []          # (name, start_s, end_s)
        self._undo = []

    def _wrap(self, fn, name: str, waits: bool, sync: bool):
        add = self.intervals.append

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                t1 = time.perf_counter()
                add((name, t0, t1))
                if waits and sync:
                    torch.cuda.synchronize()
                    add(("wait", t1, time.perf_counter()))
        return timed

    def install(self, targets, sync: bool) -> None:
        """Wrap each ``(owner, attribute, span, waits)``; ``sync``: the
        program runs on a CUDA card, so a wait can be timed."""
        for owner, attr, name, waits in targets:
            fn = getattr(owner, attr)
            self._undo.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, name, waits, sync))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []

    def total_s(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.intervals if n == name)


class GcSpans:
    """The interpreter's garbage collections over the window:
    ``(generation, start_s, end_s)`` each."""

    def __init__(self):
        self.intervals = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.intervals.append((info["generation"], self._t0,
                                   time.perf_counter()))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def named(self) -> list:
        """As host spans: ``("gc", start_s, end_s)``."""
        return [("gc", t0, t1) for _, t0, t1 in self.intervals]

    def describe(self) -> str:
        count, seconds = [0, 0, 0], [0.0, 0.0, 0.0]
        for gen, t0, t1 in self.intervals:
            count[gen] += 1
            seconds[gen] += t1 - t0
        return (f"gc collections {count} in "
                f"{[round(x, 6) for x in seconds]} s")


def _mark(stream=None) -> float:
    """Launch a spin kernel (on ``stream``), wait for it; the host time
    just before the launch."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        t = time.perf_counter()
        torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()
    return t


class DeviceTrace:
    """One profiler session over a stretch of calls, and what its trace
    says."""

    def __init__(self, side_stream):
        self.side_stream = side_stream
        self.prof = None
        self.events = []             # (name, start_s, dur_s, stream)
        self.side_id = None
        self.offset_s = None         # host time = trace time + offset
        self.start_s = self.end_s = None   # the window in trace time
        self.counts = {}             # what the trace held, for stderr
        self.n_calls = 0             # the calls inside the stretch
        self._busy = {}              # busy_intervals, by program_only

    def start(self) -> None:
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(SETTLE_S)
        # a driver with no side stream gets one that holds only this mark,
        # so that no stream of the program's is taken for the benchmark's
        side = self.side_stream or torch.cuda.Stream()
        self._host_marks = [_mark(), _mark(side)]

    def stop(self) -> None:
        self._host_marks.append(_mark())
        time.sleep(SETTLE_S)
        self.prof.__exit__(None, None, None)
        result = self.prof.profiler.kineto_results
        self.prof = None
        self._take(*profiled(result))

    def _read(self, events) -> None:
        """Read a Chrome trace's events (``traceEvents``)."""
        launches = {}                # correlation -> host launch ts (us)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            args = e.get("args", {})
            if e.get("cat") == "cuda_runtime":
                launches[args.get("correlation")] = e["ts"]
            elif e.get("cat") in _DEVICE_CATS:
                device.append((e.get("name", "?"), e["ts"], e.get("dur", 0),
                               args.get("stream"), args.get("correlation")))
        self._take(launches, device, len(events))

    def _take(self, launches: dict, device: list, n_events: int) -> None:
        """Read a session's runtime launches (``{correlation: host ts}``)
        and device operations (``(name, ts, dur, stream, correlation)``,
        times in microseconds on the trace's clock)."""
        device.sort(key=lambda d: d[1])
        marks = [d for d in device if "spin_kernel" in d[0]]
        lags = sorted(ts - launches[c] for _, ts, _, _, c in device
                      if c in launches)
        self.counts = {"events": n_events, "runtime": len(launches),
                       "device": len(device), "marks": len(marks),
                       "lag_ms": lags[len(lags) // 2] * 1e-3 if lags else None}
        if len(marks) < 3:
            return                   # no device time recorded
        first, side, last = marks[0], marks[1], marks[-1]
        self.side_id = side[3]
        offsets = [host - launches.get(m[4], m[1]) * 1e-6
                   for host, m in zip(self._host_marks, (first, side, last))]
        self.offset_s = sum(offsets) / len(offsets)
        self.drift_s = max(offsets) - min(offsets)
        self.start_s = (side[1] + side[2]) * 1e-6
        self.end_s = last[1] * 1e-6
        self.events = [(n, ts * 1e-6, dur * 1e-6, st)
                       for n, ts, dur, st, _ in device
                       if "spin_kernel" not in n
                       and self.start_s <= ts * 1e-6 < self.end_s]
        self.counts["in_window"] = len(self.events)

    # ------------------------------------------------------------ readings
    @property
    def measured(self) -> bool:
        """The trace holds device work of the program's."""
        return any(st != self.side_id for _, _, _, st in self.events)

    @property
    def window_s(self) -> float:
        return self.end_s - self.start_s

    def busy_intervals(self, program_only: bool = False) -> list:
        """Merged device-busy intervals in trace time: of every stream, or
        of the program's alone (every stream but the benchmark's side
        stream)."""
        if program_only in self._busy:
            return self._busy[program_only]
        merged = []
        for s, e in sorted((t, t + d) for _, t, d, st in self.events
                           if not (program_only and st == self.side_id)):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self._busy[program_only] = merged
        return merged

    def busy_s(self, program_only: bool = False) -> float:
        return sum(e - s for s, e in self.busy_intervals(program_only))

    def top_ops(self, n: int = 10) -> list:
        """The program's device time by operation, a kernel's name without
        its argument list (``void at::native::vectorized_gather_kernel<16,
        long>``)."""
        total = collections.Counter()
        for name, _, dur, st in self.events:
            if st != self.side_id:
                total[_short(name)] += dur
        return [[name, secs] for name, secs in total.most_common(n)]

    def gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps in the program's device work in the
        window: ``(seconds, start on the host's clock)`` each."""
        busy = self.busy_intervals(program_only=True)
        edges = [self.start_s] + [x for iv in busy for x in iv] + [self.end_s]
        return sorted(((edges[i + 1] - edges[i], edges[i] + self.offset_s)
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]

    def idle_gaps(self, host_spans, calls, call_label, n: int = 10) -> list:
        """The ``n`` longest gaps in the program's device work in the
        window, each named by what the host was doing over most of it."""
        return label_gaps(self.gaps(n), host_spans, calls, call_label)


class DeviceWindow:
    """The traced window as stretches of calls, one profiler session
    each; the readings add up the sessions that measured."""

    def __init__(self, side_stream):
        self.side_stream = side_stream
        self.parts = []              # the sessions that measured
        self.log = []                # what each session's trace held
        self.cost_s = 0.0            # sessions' starts, stops and reading
        self.calls_cap = FIRST_SESSION_CALLS   # of the next session

    @contextlib.contextmanager
    def stretch(self, calls: list):
        """Profile the calls appended to ``calls`` inside the block."""
        part = DeviceTrace(self.side_stream)
        first = len(calls)
        t0 = time.perf_counter()
        part.start()
        t1 = time.perf_counter()
        try:
            yield
        finally:
            t2 = time.perf_counter()
            part.stop()
            self.cost_s += t1 - t0 + time.perf_counter() - t2
        part.n_calls = len(calls) - first
        events = part.counts.get("events")
        if part.n_calls and events:  # the next session: SESSION_EVENTS
            self.calls_cap = max(1, min(
                SESSION_CALLS, SESSION_EVENTS * part.n_calls // events))
        self.log.append(part.counts)
        if part.measured:
            self.parts.append(part)

    def max_calls(self) -> int:
        """The calls of the next session: as many as keep it near
        :data:`SESSION_EVENTS`, at the last session's events a call."""
        return self.calls_cap

    @property
    def measured(self) -> bool:
        return bool(self.parts)

    @property
    def n_calls(self) -> int:
        return sum(p.n_calls for p in self.parts)

    @property
    def window_s(self) -> float:
        return sum(p.window_s for p in self.parts)

    def busy_s(self, program_only: bool = False) -> float:
        return sum(p.busy_s(program_only) for p in self.parts)

    def top_ops(self, n: int = 10) -> list:
        total = collections.Counter()
        for p in self.parts:
            for name, secs in p.top_ops(n=None):
                total[name] += secs
        return [[name, secs] for name, secs in total.most_common(n)]

    def idle_gaps(self, host_spans, calls, call_label, n: int = 10) -> list:
        gaps = sorted((g for p in self.parts for g in p.gaps(n)),
                      reverse=True)[:n]
        return label_gaps(gaps, host_spans, calls, call_label)

    def describe(self) -> str:
        """One line: each session's counts, and which were left out."""
        return (f"device trace: {len(self.parts)} of {len(self.log)} "
                f"sessions measured, {self.cost_s:.3f} s in their starts, "
                f"stops and reading; " + "; ".join(
                    ", ".join(f"{k} {v}" for k, v in counts.items())
                    for counts in self.log))


def profiled(result) -> tuple:
    """``(launches, device, n_events)`` of a finished session, as
    :meth:`DeviceTrace._take` reads them, from the profiler's own events
    (writing the Chrome trace and parsing it back cost about 1 ms a call
    of a bulk window).  A device operation is an event on the card; a
    runtime launch, a host event named ``cuda...`` (the profiler's own
    host events, such as module loading, share the correlation of the
    call that caused them).  Times in microseconds from the session's
    start."""
    base = result.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    launches, device = {}, []
    events = result.events()
    for e in events:
        if e.device_type() == cuda:
            device.append((e.name(), (e.start_ns() - base) * 1e-3,
                           e.duration_ns() * 1e-3, e.device_resource_id(),
                           e.correlation_id()))
        elif e.name().startswith("cuda"):
            launches[e.correlation_id()] = (e.start_ns() - base) * 1e-3
    return launches, device, len(events)


def label_gaps(gaps, host_spans, calls, call_label) -> list:
    """``[name, seconds]`` of each ``(seconds, host start)`` gap, named
    by :func:`_label` from the host spans and calls near it alone (found
    by bisection, so that a window's many calls cost no scan a gap)."""
    spans = sorted(host_spans, key=lambda sp: sp[1])
    span_starts = [t0 for _, t0, _ in spans]
    span_reach = max((t1 - t0 for _, t0, t1 in spans), default=0.0)
    call_starts = [t0 for t0, _, _ in calls]
    call_reach = max((t1 - t0 for t0, t1, _ in calls), default=0.0)
    out = []
    for length, g0 in gaps:
        g1 = g0 + length
        near = spans[bisect.bisect_left(span_starts, g0 - span_reach):
                     bisect.bisect_right(span_starts, g1)]
        inside = calls[bisect.bisect_left(call_starts, g0 - call_reach):
                       bisect.bisect_right(call_starts, g1)]
        out.append([_label(g0, g1, near, inside, call_label), length])
    return out


@functools.cache
def _short(name: str) -> str:
    """A kernel's name up to its argument list: the first ``(`` outside
    the template brackets."""
    if "::" not in name:
        return name                  # "Memcpy HtoD (Pageable -> Device)"
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _label(g0, g1, host_spans, calls, call_label) -> str:
    """The innermost host span covering most of ``[g0, g1]``: a garbage
    collection, report inside execute inside the call; outside every
    call, the harness."""
    cover = collections.Counter()
    for name, t0, t1 in host_spans:
        if t1 > g0 and t0 < g1:
            cover[name] += _overlap(g0, g1, t0, t1)
    if cover["gc"] > (g1 - g0) / 2:
        return "gc"
    cover["execute"] -= cover["report"]
    inside = sum(_overlap(g0, g1, t0, t1) for t0, t1, _ in calls)
    cover[call_label] = inside - sum(cover[k] for k in
                                     ("report", "execute", "wait", "copy"))
    cover["harness"] = (g1 - g0) - inside
    return max(cover.items(), key=lambda kv: kv[1])[0]
