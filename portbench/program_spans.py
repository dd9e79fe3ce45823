"""The program's own spans and counters over the window, for the metric
readers of ``source: program_span`` that read them.

``repro_torch.telemetry`` keeps one row a root call (``CompiledDesign.mul``
or ``.serve``), always on: the window's rows are those inside the first
timed call's start and the last one's end.  Warm-up calls come before
the window, and between timed calls only the benchmark's own code runs,
so a sound window has one row a timed call.  A program without the
recorder, or a window whose rows do not match its calls one for one,
reads nothing (``None``).
"""
from __future__ import annotations


def window_rows(rec) -> list | None:
    """The program's rows of the window's calls, or ``None``."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None                 # a program from before the recorder
    if not rec.calls:
        return None
    rows = telemetry.calls(rec.calls[0][0], rec.calls[-1][1])
    return rows if len(rows) == rec.n_calls else None


def span_ms(rec, name: str) -> float | None:
    """A span's seconds over the window, per timed call (ms)."""
    rows = window_rows(rec)
    if rows is None:
        return None
    return sum(r.seconds[name] for r in rows) / rec.n_calls * 1e3


def counter_per_call(rec, name: str) -> float | None:
    """A counter's sum over the window, per timed call."""
    rows = window_rows(rec)
    if rows is None:
        return None
    return sum(r.counters[name] for r in rows) / rec.n_calls
