"""Scheduler layer: dispatch policies for multiplier banks.

The folding literature (Möller et al., "Model-based Hardware Design for
FPGAs using Folding Transformations"; "Operand Folding Hardware
Multipliers") treats the *schedule* -- which operation runs on which
shared instance on which cycle -- as a first-class, swappable design
object.  This module does the same for the bank engine: a ``Scheduler``
maps ``(cts, n_ops)`` to a static ``(assignment, makespan)`` pair, where

  * ``cts[i]`` is instance i's cycle time (issue interval, = 1/TP_i),
  * ``assignment[i]`` is the tuple of op indices instance i executes,
  * ``makespan`` is the cycle on which the last result retires.

Because the contract is *static* for a given batch size, every policy
keeps ``Bank.execute`` static: the schedule lowers to constant
gather/scatter indices, never to data-dependent control flow.

Policies
--------
``round_robin``   Cycle-accurate polling in instance order: each cycle,
                  every free instance accepts the next pending op.  This
                  is the paper's Sec. V-E silicon bank behaviour and the
                  PR-2 default.
``greedy``        Earliest-completion-time list scheduling.  Ops are
                  placed on the instance that would *finish* them first.
                  For identical ops on instances of speeds 1/ct this is
                  provably makespan-optimal (the k-th op on instance i
                  can finish no earlier than k*ct_i; greedy picks the
                  n smallest such slots), so its makespan is always
                  <= round_robin's -- strictly better on heterogeneous
                  CT banks whose slow units would otherwise catch the
                  tail of the queue.
``streaming``     Ops are *not* all available at cycle 0: an arrival
                  trace assigns each op an arrival cycle, and free
                  instances poll the queue of arrived ops each cycle
                  (async dispatch, the serving use case).  With an
                  all-zero trace it reduces exactly to round_robin.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Protocol, runtime_checkable


@runtime_checkable
class Scheduler(Protocol):
    """Dispatch policy: (cts, n_ops) -> static (assignment, makespan)."""

    name: str

    def schedule(self, cts: tuple, n_ops: int) -> tuple:
        """Return ``(assignment, makespan)``.

        ``assignment`` is a tuple (one entry per instance) of tuples of
        op indices; every op index in ``range(n_ops)`` appears exactly
        once.  ``makespan`` is the retire cycle of the last op.
        """
        ...


# ---------------------------------------------------------------- policies

@functools.lru_cache(maxsize=1024)
def round_robin_schedule(cts: tuple, n_ops: int) -> tuple:
    """Cycle-accurate round-robin issue of ``n_ops`` over instances.

    Each cycle, instances are polled in order; a free instance accepts
    the next pending op and stays busy for its CT.
    """
    n_inst = len(cts)
    free_at = [0] * n_inst
    assign = [[] for _ in range(n_inst)]
    issued = 0
    cycle = 0
    while issued < n_ops:
        for i in range(n_inst):
            if issued >= n_ops:
                break
            if free_at[i] <= cycle:
                assign[i].append(issued)
                free_at[i] = cycle + cts[i]
                issued += 1
        cycle += 1
    makespan = max((free_at[i] for i in range(n_inst) if assign[i]),
                   default=0)
    return tuple(tuple(ops) for ops in assign), makespan


@functools.lru_cache(maxsize=1024)
def greedy_schedule(cts: tuple, n_ops: int) -> tuple:
    """Earliest-completion-time list scheduling (optimal for equal ops).

    Op k goes to the instance minimising ``free_at[i] + cts[i]`` (ties
    broken by instance order, so Stars placed first by the planner win
    them).  Completion slots on instance i form the chain ct_i, 2*ct_i,
    ...; greedy consumes the globally smallest n slots, hence the
    makespan is the n-th smallest slot value -- a lower bound for *any*
    schedule -- so ``greedy <= round_robin`` always holds.
    """
    import heapq
    n_inst = len(cts)
    assign = [[] for _ in range(n_inst)]
    heap = [(cts[i], i) for i in range(n_inst)]
    heapq.heapify(heap)
    makespan = 0
    for op in range(n_ops):
        done, i = heapq.heappop(heap)
        assign[i].append(op)
        makespan = max(makespan, done)
        heapq.heappush(heap, (done + cts[i], i))
    return tuple(tuple(ops) for ops in assign), makespan


@functools.lru_cache(maxsize=1024)
def streaming_schedule(cts: tuple, n_ops: int, arrivals: tuple) -> tuple:
    """Async dispatch against a per-op arrival trace.

    ``arrivals[k]`` is the cycle op k becomes available (nondecreasing).
    Each cycle, free instances poll the queue of *arrived* ops in
    round-robin order; an instance never idles while an arrived op is
    pending (work-conserving), but an op can never issue before it
    arrives.  An all-zero trace therefore reproduces round_robin
    exactly.
    """
    if len(arrivals) != n_ops:
        raise ValueError(
            f"arrival trace has {len(arrivals)} entries for {n_ops} ops")
    if any(b < a for a, b in zip(arrivals, arrivals[1:])):
        raise ValueError("arrival trace must be nondecreasing")
    n_inst = len(cts)
    free_at = [0] * n_inst
    assign = [[] for _ in range(n_inst)]
    issued = 0
    cycle = 0
    while issued < n_ops:
        if arrivals[issued] > cycle:
            cycle = arrivals[issued]        # fast-forward an idle bank
        for i in range(n_inst):
            if issued >= n_ops or arrivals[issued] > cycle:
                break
            if free_at[i] <= cycle:
                assign[i].append(issued)
                free_at[i] = cycle + cts[i]
                issued += 1
        cycle += 1
    makespan = max((free_at[i] for i in range(n_inst) if assign[i]),
                   default=0)
    return tuple(tuple(ops) for ops in assign), makespan


def uniform_arrivals(n_ops: int, per_cycle: int) -> tuple:
    """Deterministic arrival trace: ``per_cycle`` ops arrive each cycle."""
    if per_cycle < 1:
        raise ValueError("per_cycle >= 1")
    return tuple(k // per_cycle for k in range(n_ops))


# --------------------------------------------------- completion accounting

def completion_cycles(cts: tuple, assignment: tuple,
                      arrivals: tuple | None = None) -> tuple:
    """Per-op completion cycle reconstructed from an assignment.

    Every registered policy is work-conserving and issues each
    instance's ops in the order its assignment tuple lists them, so the
    per-instance chain ``issue_k = max(prev_finish, arrival_k)``,
    ``finish_k = issue_k + ct`` reproduces the simulation exactly: an
    instance whose next assigned op has arrived never idles (if it
    could idle, the polling loop would have handed the op to it -- or
    to an earlier-polled free instance, contradicting the assignment).
    This is the single accounting path both ``Bank.report``'s latency
    histogram and the serving layer's online metrics derive from.
    """
    n_ops = sum(len(ops) for ops in assignment)
    arr = (0,) * n_ops if arrivals is None else tuple(arrivals)
    if len(arr) != n_ops:
        raise ValueError(
            f"arrival trace has {len(arr)} entries for {n_ops} ops")
    finish = [0] * n_ops
    for ops, ct in zip(assignment, cts):
        free = 0
        for k in ops:
            free = max(free, arr[k]) + ct
            finish[k] = free
    return tuple(finish)


def latency_histogram(latencies) -> tuple:
    """Collapse per-request latencies into sorted ((latency, count), ...).

    The compact exchange format between the bank's offline reports and
    the serving layer's online metrics (identical bucketing: exact
    integer cycles, no binning)."""
    counts = {}
    for lat in latencies:
        counts[lat] = counts.get(lat, 0) + 1
    return tuple(sorted(counts.items()))


def histogram_percentile(hist: tuple, q: float):
    """Smallest latency whose cumulative count covers quantile ``q``.

    ``hist`` is ``latency_histogram`` output; returns None when empty.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(c for _, c in hist)
    if not total:
        return None
    need = max(1, math.ceil(q * total))
    seen = 0
    for lat, c in hist:
        seen += c
        if seen >= need:
            return lat
    return hist[-1][0]


# ------------------------------------------------------------- registry

@dataclasses.dataclass(frozen=True)
class RoundRobinScheduler:
    name: str = "round_robin"

    def schedule(self, cts: tuple, n_ops: int) -> tuple:
        return round_robin_schedule(tuple(cts), n_ops)


@dataclasses.dataclass(frozen=True)
class GreedyScheduler:
    name: str = "greedy"

    def schedule(self, cts: tuple, n_ops: int) -> tuple:
        return greedy_schedule(tuple(cts), n_ops)


@dataclasses.dataclass(frozen=True)
class StreamingScheduler:
    """Arrival-driven dispatch.  ``arrivals`` fixes a trace for every
    batch; ``arrival_rate`` derives a uniform trace per batch size
    (``arrival_rate`` ops arrive per cycle).  With neither set, all ops
    arrive at cycle 0 (== round_robin)."""
    arrivals: tuple | None = None
    arrival_rate: int | None = None
    name: str = "streaming"

    def arrivals_for(self, n_ops: int) -> tuple:
        """The arrival trace this policy dispatches ``n_ops`` against
        (``Bank.report`` asks for it to turn completions into
        admission-to-completion latencies)."""
        if self.arrivals is not None:
            trace = tuple(self.arrivals)[:n_ops]
            if len(trace) < n_ops:
                raise ValueError(
                    f"arrival trace has {len(trace)} entries, need {n_ops}")
            return trace
        if self.arrival_rate is not None:
            return uniform_arrivals(n_ops, self.arrival_rate)
        return (0,) * n_ops

    def schedule(self, cts: tuple, n_ops: int) -> tuple:
        return streaming_schedule(tuple(cts), n_ops,
                                  self.arrivals_for(n_ops))


SCHEDULERS = {
    "round_robin": RoundRobinScheduler(),
    "greedy": GreedyScheduler(),
    "streaming": StreamingScheduler(),
}


def register_scheduler(sched: Scheduler) -> Scheduler:
    """Add a policy to the registry (later scaling PRs plug in here)."""
    SCHEDULERS[sched.name] = sched
    return sched


def get_scheduler(which) -> Scheduler:
    """Resolve a scheduler by name or pass a Scheduler object through."""
    if isinstance(which, str):
        try:
            return SCHEDULERS[which]
        except KeyError:
            raise ValueError(
                f"unknown scheduler {which!r}; "
                f"registered: {tuple(SCHEDULERS)}") from None
    if isinstance(which, Scheduler):
        return which
    raise TypeError(f"scheduler must be a name or Scheduler, got {which!r}")
