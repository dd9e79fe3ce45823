"""The program's own spans and counters over the window, for the metric
readers of ``source: program_span`` that read them.

``repro_torch.telemetry`` keeps one row a root call (``CompiledDesign.mul``
or ``.serve``), always on, in a ring of its last ``CAPACITY`` rows.  A
traced run reads the rows stretch by stretch (:class:`ProgramRows`): at
the end of each stretch of calls, between calls and off the clock, the
rows inside the stretch's first call's start and last call's end, kept
as sums.  Warm-up calls come before the window, and between timed calls
only the benchmark's own code runs, so a sound stretch has one row a
timed call, however long the window and however small the ring.  A
program without the recorder, or a stretch whose rows do not match its
calls one for one, makes the window read nothing (``None``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager


def _telemetry():
    try:
        from repro_torch import telemetry
    except ImportError:
        return None                 # a program from before the recorder
    return telemetry


class ProgramRows:
    """The program's rows of a window's calls, read stretch by stretch
    and kept as sums of each span's seconds and each counter."""

    def __init__(self):
        self.n_calls = 0             # the calls whose rows were read
        self.stretches = 0
        self.unmatched = 0           # stretches not one row a call
        self.seconds = {}
        self.counters = {}
        self.read_s = 0.0            # the time the reading took

    def add(self, calls: list) -> None:
        """Read the rows of one stretch's ``calls``."""
        if not calls:
            return
        self.stretches += 1
        telemetry = _telemetry()
        rows = [] if telemetry is None else \
            telemetry.calls(calls[0][0], calls[-1][1])
        if len(rows) != len(calls):
            self.unmatched += 1
            return
        self.n_calls += len(rows)
        for row in rows:
            for sums, values in ((self.seconds, row.seconds),
                                 (self.counters, row.counters)):
                for name, v in values.items():
                    sums[name] = sums.get(name, 0) + v

    @contextmanager
    def stretch(self, calls: list):
        """Read the rows of the calls appended to ``calls`` inside the
        block, once it ends."""
        first = len(calls)
        yield
        t0 = time.perf_counter()
        self.add(calls[first:])
        self.read_s += time.perf_counter() - t0

    def describe(self) -> str:
        return (f"program rows: {self.n_calls} calls' rows read in "
                f"{self.stretches} stretches ({self.read_s:.3f} s), "
                f"{self.unmatched} of them not one row a call")


def window_sums(rec) -> ProgramRows | None:
    """The sums of the program's rows of the window's calls, or ``None``.
    A record with no rows read stretch by stretch reads its whole window
    as one stretch now."""
    if not rec.calls:
        return None
    sums = rec.program
    if sums is None:
        sums = ProgramRows()
        sums.add(rec.calls)
    if sums.unmatched or sums.n_calls != rec.n_calls:
        return None
    return sums


def span_ms(rec, name: str) -> float | None:
    """A span's seconds over the window, per timed call (ms)."""
    sums = window_sums(rec)
    if sums is None:
        return None
    return sums.seconds[name] / rec.n_calls * 1e3


def counter_per_call(rec, name: str) -> float | None:
    """A counter's sum over the window, per timed call; nothing where the
    program has no such counter."""
    sums = window_sums(rec)
    if sums is None or name not in sums.counters:
        return None
    return sums.counters[name] / rec.n_calls
