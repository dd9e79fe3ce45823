"""The port's one recorder of spans and counters, always on.

A **root** is one call of a public entry that users time:
``CompiledDesign.mul`` (``design.mul``) and ``CompiledDesign.serve``
(``design.serve``).  Each root call gets an increasing id and its start
and end on ``time.perf_counter()``, the clock a caller times the call
with, and one row in a ring of the last :data:`CAPACITY` root calls.  A
root opened inside another root is a child span of the outer one.

A **span** (:func:`span`) adds the seconds it measured and a count of 1
to the current root's row and to the process totals; a **counter**
(:func:`count`) adds an integer to both.  Outside any root they reach the
process totals only (a caller driving ``Bank.execute`` directly, say).
A span's parent is fixed by where the code calls it:

====================  ======================  =============================
span / counter        parent                  what it measures
====================  ======================  =============================
bank.schedule         Bank.report             the scheduler's pass, on a
                                              report-cache miss
bank.latency          Bank.report             completion cycles +
                                              histogram, on such a miss
bank.report_builds    Bank.report             (counter) such misses
bank.dispatch_build   Bank.execute            a batch size's first dispatch
bank.dispatch_builds  Bank.execute            (counter) such builds
bank_fold.launch      fused dispatch ``run``  the custom op's host side
worker.admit          Worker.run              a window's admissions + steals
worker.round_host     Worker._execute_round   a round's packing + unpacking
worker.rows           Worker._execute_round   (counter) a round's requests
worker.bucket_rows    Worker._execute_round   (counter) its padded rows
launch.<kernel>       kernels._build.launch   (counter) launches
launch.<kernel>.<p>   kernels._build.launch   (counter) launches by path
====================  ======================  =============================

Recording costs two ``perf_counter`` reads a span at its caller and two
additions into the open row (or the totals) here: no object is made but
the floats themselves.  A root makes its row and, at its end, adds it
into the totals and keeps it as an array.  The span and counter names are fixed below; each
has its own column.

One thread: the port's serving and bank paths run on the caller's
thread, and nothing here takes a lock.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from array import array
from operator import add
from time import perf_counter

#: rows kept: the last CAPACITY root calls, 392 bytes each (a 51 s serve
#: window makes about 4,600; a 51 s bulk window about 55,000 at 32 bits,
#: and up to 75,000 were a call only its round's 0.68 ms of device work)
CAPACITY = 131_072
ROOTS = ("design.mul", "design.serve")
#: the kernels ``kernels._build.launch`` counts, and the paths of those
#: with two (``kernels/_row_tiles.py``)
KERNELS = ("bank_fold", "mcim_fold_fb", "mcim_fold_ff",
           "mcim_fold_karatsuba", "prefix_adder", "karatsuba_ppm",
           "int8_matmul")
KERNEL_PATHS = {k: ("bulk", "per_thread")
                for k in ("bank_fold", "mcim_fold_fb", "mcim_fold_ff",
                          "karatsuba_ppm")}
SPANS = ROOTS + ("bank.schedule", "bank.latency", "bank.dispatch_build",
                 "bank_fold.launch", "worker.admit", "worker.round_host")
COUNTERS = (("bank.report_builds", "bank.dispatch_builds", "worker.rows",
             "worker.bucket_rows")
            + tuple(f"launch.{k}" for k in KERNELS)
            + tuple(f"launch.{k}.{p}" for k, paths in KERNEL_PATHS.items()
                    for p in paths))

# a row: id, root, t0, t1, then (seconds, count) a span, then the counters
_HEAD = 4
_SPAN_COL = {name: _HEAD + 2 * i for i, name in enumerate(SPANS)}
_COUNTER_COL = {name: _HEAD + 2 * len(SPANS) + i
                for i, name in enumerate(COUNTERS)}
_WIDTH = _HEAD + 2 * len(SPANS) + len(COUNTERS)

_ring = collections.deque(maxlen=CAPACITY)   # closed rows, as arrays
_totals = [0.0] * _WIDTH     # outside roots, and each root's row as it ends
_row = None                  # the open root's row (a list), or None
_ids = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Call:
    """One root call: ``seconds`` and ``spans`` give each span's inclusive
    seconds and count inside it, ``counters`` each counter's sum."""
    id: int
    root: str
    t0: float
    t1: float
    seconds: dict
    spans: dict
    counters: dict


def span(name: str, seconds: float) -> None:
    """Add a span of ``seconds`` under ``name`` (one of :data:`SPANS`)."""
    i = _SPAN_COL[name]
    row = _row
    if row is None:
        row = _totals
    row[i] += seconds
    row[i + 1] += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`)."""
    row = _row
    if row is None:
        row = _totals
    row[_COUNTER_COL[name]] += n


class root:
    """``with root("design.mul"):`` -- one root call (see the module
    docstring); closed on any exit, an exception's included."""
    __slots__ = ("name", "_t0", "_nested")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _row
        self._nested = _row is not None
        if not self._nested:
            row = [0.0] * _WIDTH
            row[0] = next(_ids)
            row[1] = ROOTS.index(self.name)
            _row = row
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        global _row
        t1 = perf_counter()
        if not self._nested:
            row, _row = _row, None
            row[2], row[3] = self._t0, t1
            _ring.append(array("d", row))
            _totals[:] = map(add, _totals, row)
        # nested: a child of the outer root; else the totals' alone
        span(self.name, t1 - self._t0)


def _columns(row) -> tuple:
    return ({n: row[i] for n, i in _SPAN_COL.items()},
            {n: int(row[i + 1]) for n, i in _SPAN_COL.items()},
            {n: int(row[i]) for n, i in _COUNTER_COL.items()})


def calls(t0: float, t1: float) -> list:
    """The root calls that started at or after ``t0`` and ended at or
    before ``t1`` (``perf_counter`` times), oldest first, of the last
    :data:`CAPACITY`."""
    return [Call(int(row[0]), ROOTS[int(row[1])], row[2], row[3],
                 *_columns(row))
            for row in _ring if row[2] >= t0 and row[3] <= t1]


def totals() -> dict:
    """Every span's seconds and count and every counter's sum in this
    process since the last :func:`reset`, inside roots and outside:
    ``{"seconds": {...}, "spans": {...}, "counters": {...}}``."""
    now = _totals if _row is None else list(map(add, _totals, _row))
    return dict(zip(("seconds", "spans", "counters"), _columns(now)))


def reset() -> None:
    """Zero the process totals (the rows are kept; an open root's row
    adds only what follows)."""
    _totals[:] = [0.0] * _WIDTH if _row is None else [0.0 - x for x in _row]
