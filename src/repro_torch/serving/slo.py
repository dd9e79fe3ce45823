"""SLO-aware dispatch: earliest-deadline-first scheduling + admission.

Two layers, deliberately split:

* :class:`SLOScheduler` joins the round_robin/greedy/streaming family
  in :mod:`repro_torch.core.bank.schedule`: a *complete* policy mapping
  ``(cts, n_ops)`` to a static ``(assignment, makespan)`` pair.  Ops
  are ordered earliest-deadline-first (ties: arrival, then index) and
  list-scheduled onto the instance that finishes each earliest.  With
  no deadlines and no arrivals configured the order degenerates to op
  index and the placement rule to earliest-completion-time, i.e. the
  policy reproduces ``greedy_schedule`` exactly -- a property the test
  suite pins.  Because it is complete and deterministic it passes the
  same verifier contracts (``verify/contracts.check_scheduler``) as
  every other registered policy; it is registered at import, so the
  ``verify.contracts.check_all_schedulers`` sweep covers it by
  construction.

* Admission control lives in :func:`earliest_completion` /
  :func:`admissible`: *refusing* work is a serving-loop decision, not a
  schedule-shape one (a Scheduler must assign every op -- the
  completeness contract).  The worker consults these against the
  committed per-instance ``free_at`` horizon before a request ever
  reaches a schedule: a request is refused iff even the best instance,
  issuing as early as possible, would retire it after its deadline --
  so every refusal is provably infeasible (no preemption, committed
  work is never reordered) and every admission carries a slot that
  meets the SLO.  Missing an SLO silently is therefore structurally
  impossible: the failure mode is an explicit refusal at admission.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.bank.schedule import register_scheduler

#: deadline value meaning "no SLO" (sorts after every real deadline)
NO_DEADLINE = math.inf


@functools.lru_cache(maxsize=1024)
def edf_schedule(cts: tuple, n_ops: int, arrivals: tuple,
                 deadlines: tuple) -> tuple:
    """EDF list scheduling: static (assignment, makespan), complete.

    Ops are taken in (deadline, arrival, index) order; each goes to the
    instance minimizing its completion ``max(free, arrival) + ct``
    (ties: lowest instance index).  Per-instance issue order equals
    append order, so
    :func:`~repro_torch.core.bank.schedule.completion_cycles`
    reconstructs this schedule's finish times exactly -- one accounting
    path for offline reports and online serving alike.
    """
    if len(arrivals) != n_ops:
        raise ValueError(
            f"arrival trace has {len(arrivals)} entries for {n_ops} ops")
    if len(deadlines) != n_ops:
        raise ValueError(
            f"deadline trace has {len(deadlines)} entries for {n_ops} ops")
    n_inst = len(cts)
    order = sorted(range(n_ops),
                   key=lambda k: (deadlines[k], arrivals[k], k))
    free = [0] * n_inst
    assign = [[] for _ in range(n_inst)]
    makespan = 0
    for k in order:
        best = min(range(n_inst),
                   key=lambda i: (max(free[i], arrivals[k]) + cts[i], i))
        done = max(free[best], arrivals[k]) + cts[best]
        free[best] = done
        assign[best].append(k)
        makespan = max(makespan, done)
    return tuple(tuple(ops) for ops in assign), makespan


@dataclasses.dataclass(frozen=True)
class SLOScheduler:
    """Earliest-deadline-first dispatch with optional arrival trace.

    ``deadlines``/``arrivals`` fix absolute per-op traces (prefixes are
    taken per batch, like StreamingScheduler); with neither set every
    op is due "eventually" and available at cycle 0, which reduces the
    policy to greedy earliest-completion-time dispatch.
    """
    arrivals: tuple | None = None
    deadlines: tuple | None = None
    name: str = "slo_edf"

    def arrivals_for(self, n_ops: int) -> tuple:
        if self.arrivals is None:
            return (0,) * n_ops
        trace = tuple(self.arrivals)[:n_ops]
        if len(trace) < n_ops:
            raise ValueError(
                f"arrival trace has {len(trace)} entries, need {n_ops}")
        return trace

    def deadlines_for(self, n_ops: int) -> tuple:
        if self.deadlines is None:
            return (NO_DEADLINE,) * n_ops
        trace = tuple(self.deadlines)[:n_ops]
        if len(trace) < n_ops:
            raise ValueError(
                f"deadline trace has {len(trace)} entries, need {n_ops}")
        return trace

    def schedule(self, cts: tuple, n_ops: int) -> tuple:
        return edf_schedule(tuple(cts), n_ops,
                            self.arrivals_for(n_ops),
                            self.deadlines_for(n_ops))


#: the registered default instance (spec.scheduler="slo_edf" resolves
#: to it once repro_torch.serving is imported)
SLO_SCHEDULER = register_scheduler(SLOScheduler())


# ------------------------------------------------------------- admission

def earliest_completion(cts: tuple, free_at, arrival: int) -> int:
    """Best retire cycle any instance can offer a new op.

    ``free_at[i]`` is instance i's committed busy-until horizon; the op
    can issue at ``max(free_at[i], arrival)`` and retires ``cts[i]``
    later.  This is exact for non-preemptive committed work: no
    reordering of already-admitted ops can make any instance free
    earlier than its horizon.
    """
    return min(max(f, arrival) + ct for f, ct in zip(free_at, cts))


def admissible(cts: tuple, free_at, arrival: int, deadline) -> bool:
    """Can ANY instance provably retire the op by its deadline?"""
    return earliest_completion(cts, free_at, arrival) <= deadline
