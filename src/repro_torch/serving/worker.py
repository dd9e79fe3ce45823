"""The online serving worker loop: admit -> batch -> dispatch -> complete.

The port's copy of the reference package's ``serving/worker.py``.
``CompiledDesign.replay`` is post-hoc: it scores a finished arrival
trace against a bank.  This module makes dispatch *online*, the
vLLM-worker-loop shape: a :class:`Worker` owns N independent bank
replicas of one ``CompiledDesign`` and advances a simulated bank clock
in dispatch windows of ``round_cycles``.  Each window it

  1. **admits** every request that arrived in the window, in
     (arrival, deadline, rid) order -- EDF among simultaneous arrivals.
     A front-end router round-robins requests over live replicas
     (``rid % n_live``, the cheap load balancer real fleets put in
     front of workers); admission control (:mod:`.slo`) commits the
     request to the home replica's earliest-finishing instance, spills
     to the globally best replica when the home misses the deadline,
     and *refuses* when no live instance can provably retire it in
     time.  Committed slots are never preempted, so an admitted
     request structurally cannot miss its SLO -- the failure mode is
     an explicit refusal, recorded with its evidence
     (``Response.earliest_possible``);
  2. **steals work** across replicas: bursty routing leaves ragged
     queues, so the least-backlogged replica pulls not-yet-issued
     commits off the most-backlogged replica's queue tails whenever
     that strictly improves their finish cycle (deadlines can only get
     safer);
  3. **dispatches** every commit retiring inside the window as ONE
     bank round per replica -- one ``Bank.execute`` call over the
     gathered operands (padded to a power-of-two bucket so ragged
     windows reuse the bank's per-batch dispatches), which on the fused
     backend is a single ``bank_fold`` launch per round: one
     host-to-device copy of the operands and one synchronising copy of
     the products back;
  4. **autoscales**: an optional :class:`~.autoscale.Autoscaler`
     watches the observed arrival rate vs the per-replica provisioned
     ``Plan.throughput`` and grows the fleet immediately / drains it
     patiently (a draining replica takes no new work and retires once
     its queue is empty).

Cycle accounting is exact and shared with the offline path: committed
issue/finish chains are precisely what
``core.bank.schedule.completion_cycles`` reconstructs, and latency
histograms use the same helpers ``Bank.report`` uses.  Numeric results
are bit-exact vs the Python-bigint oracle regardless of policy,
backend or stealing (``check=True`` verifies every response).
"""
from __future__ import annotations

import dataclasses
import time
from fractions import Fraction

import numpy as np

from repro_torch import telemetry
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank
from repro_torch.core.bank.schedule import histogram_percentile, latency_histogram

from .requests import Request, Response
from .slo import earliest_completion

__all__ = ["Worker", "Replica", "ServingReport"]


@dataclasses.dataclass
class _Commit:
    """One admitted request bound to a (replica, instance, issue) slot."""
    req: Request
    replica: int
    instance: int
    issue: int
    finish: int
    prev_free: int          # instance horizon before this commit (steal undo)
    earliest_possible: int  # admission proof (<= deadline)
    stolen: bool = False


class Replica:
    """One independent bank replica: committed horizon + pending queue."""

    def __init__(self, index: int, bank: Bank):
        self.index = index
        self.bank = bank
        self.cts = tuple(cfg.ct for cfg in bank.instances)
        self.free_at = [0] * len(self.cts)     # committed busy-until
        self.queues = [[] for _ in self.cts]   # pending commits, issue order
        self.busy_cycles = [0] * len(self.cts)
        self.draining = False
        self.retired = False

    def backlog(self, now: int) -> int:
        """Committed cycles beyond ``now`` on the worst instance."""
        return max(max(f - now, 0) for f in self.free_at)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def commit(self, req: Request, earliest: int, *,
               stolen: bool = False) -> _Commit:
        """Bind ``req`` to this replica's earliest-finishing instance."""
        i = min(range(len(self.cts)),
                key=lambda j: (max(self.free_at[j], req.arrival)
                               + self.cts[j], j))
        issue = max(self.free_at[i], req.arrival)
        c = _Commit(req=req, replica=self.index, instance=i, issue=issue,
                    finish=issue + self.cts[i], prev_free=self.free_at[i],
                    earliest_possible=earliest, stolen=stolen)
        self.free_at[i] = c.finish
        self.queues[i].append(c)
        return c

    def best_completion(self, arrival: int) -> int:
        return earliest_completion(self.cts, self.free_at, arrival)

    def steal_candidate(self, now: int):
        """The latest-finishing queue-tail commit not yet issued."""
        best = None
        for q in self.queues:
            if q and q[-1].issue >= now:
                if best is None or q[-1].finish > best.finish:
                    best = q[-1]
        return best

    def unqueue_tail(self, c: _Commit) -> None:
        """Undo the LAST commit on ``c``'s instance (steal bookkeeping)."""
        q = self.queues[c.instance]
        assert q and q[-1] is c, "only queue tails are stealable"
        q.pop()
        self.free_at[c.instance] = c.prev_free


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """Aggregate metrics of one sustained-load serving run."""
    design: str                 # plan description served
    n_requests: int
    n_admitted: int
    n_refused: int
    n_completed: int
    slo_violations: int         # admitted requests retired past deadline
    steals: int                 # commits rebalanced across replicas
    rounds: int                 # bank rounds dispatched (execute calls)
    max_round_batch: int        # largest single-round batch (pre-padding)
    horizon_cycles: int         # first arrival .. last retire
    offered_rate: float         # requests/cycle over the horizon
    goodput: float              # deadline-met completions/cycle
    provisioned_tp: str         # per-replica Plan.throughput (Fraction)
    latency_hist: tuple         # ((cycles, count), ...) admitted requests
    utilization: tuple          # per replica: per-instance busy/horizon
    replica_timeline: tuple     # ((cycle, n_live), ...) autoscale trace
    wall_s: float
    n_checked: int = 0          # oracle-verified responses (check=True)
    n_mismatch: int = 0

    @property
    def slo_violation_rate(self) -> float:
        return self.slo_violations / self.n_admitted if self.n_admitted \
            else 0.0

    @property
    def refusal_rate(self) -> float:
        return self.n_refused / self.n_requests if self.n_requests else 0.0

    @property
    def bit_exact(self):
        """True/False when oracle-checked, None when check was off."""
        return self.n_mismatch == 0 if self.n_checked else None

    def latency_percentile(self, q: float):
        return histogram_percentile(self.latency_hist, q)

    @property
    def latency_p50(self):
        return self.latency_percentile(0.50)

    @property
    def latency_p99(self):
        return self.latency_percentile(0.99)

    def describe(self) -> str:
        return (f"ServingReport[{self.design}: {self.n_requests} reqs "
                f"offered={self.offered_rate:.3f}/cy "
                f"goodput={self.goodput:.3f}/cy "
                f"p50={self.latency_p50} p99={self.latency_p99} cy "
                f"refused={self.n_refused} viol={self.slo_violations} "
                f"steals={self.steals} rounds={self.rounds}]")


def _bucket(n: int) -> int:
    """Round a ragged round batch up to a power of two (dispatch reuse)."""
    b = 1
    while b < n:
        b <<= 1
    return b


class Worker:
    """Online serving loop over N replicas of one compiled design.

    ``design`` is a :class:`repro_torch.designs.CompiledDesign`
    (serving replicas are independent Banks on the design's device,
    on one host's simulated clock -- distinct from ``spec.replicas``,
    which would shard one logical bank over several devices).  ``run(requests)`` drives the loop to completion
    and returns a :class:`ServingReport`; ``responses`` holds the
    per-request outcomes afterwards.
    """

    def __init__(self, design, *, replicas: int = 1,
                 round_cycles: int | None = None, steal: bool = True,
                 autoscaler=None, check: bool = False):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.design = design
        self.plan = design.plan
        self.spec = design.spec
        self.backend = design.bank.backend
        max_ct = max(cfg.ct for cfg in design.bank.instances)
        self.round_cycles = round_cycles or max(16, 2 * max_ct)
        if self.round_cycles < 1:
            raise ValueError("round_cycles must be >= 1")
        self.steal = steal
        self.autoscaler = autoscaler
        self.check = check
        self.replicas = [self._new_replica(i) for i in range(replicas)]
        self.responses = {}
        self.steals = 0
        self.rounds = 0
        self.max_round_batch = 0
        self.n_checked = 0
        self.n_mismatch = 0
        self._timeline = []

    # ---------------------------------------------------------- replicas
    def _new_replica(self, index: int) -> Replica:
        # same plan/backend/device on every replica: cached_mul shares
        # the per-instance multipliers, so replica N+1 is cheap to spin up
        bank = Bank(self.plan, self.spec.bits_a, self.spec.bits_b,
                    backend=self.backend,
                    scheduler=self.design.bank.scheduler.name,
                    device=self.design.device)
        return Replica(index, bank)

    def _live(self) -> list:
        return [r for r in self.replicas if not (r.draining or r.retired)]

    # --------------------------------------------------------- admission
    def _admit(self, req: Request) -> None:
        live = self._live()
        earliest = min(r.best_completion(req.arrival) for r in live)
        if earliest > req.deadline:
            # provably infeasible: even the globally best instance,
            # issuing as early as possible, retires past the deadline
            self.responses[req.rid] = Response(
                rid=req.rid, admitted=False, arrival=req.arrival,
                deadline=req.deadline, earliest_possible=earliest)
            return
        home = live[req.rid % len(live)]
        rep = home if home.best_completion(req.arrival) <= req.deadline \
            else min(live, key=lambda r: (r.best_completion(req.arrival),
                                          r.index))
        rep.commit(req, earliest)

    # ------------------------------------------------------ work stealing
    def _steal_pass(self, now: int) -> None:
        """Rebalance queue tails until no steal improves a finish cycle."""
        budget = sum(r.pending() for r in self.replicas)
        while budget > 0:
            budget -= 1
            live = self._live()
            if len(live) < 2:
                return
            thief = min(live, key=lambda r: (r.backlog(now), r.index))
            victim = max(live, key=lambda r: (r.backlog(now), -r.index))
            if victim is thief:
                return
            c = victim.steal_candidate(now)
            if c is None:
                return
            j = min(range(len(thief.cts)),
                    key=lambda i: (max(thief.free_at[i], c.req.arrival)
                                   + thief.cts[i], i))
            new_finish = max(thief.free_at[j], c.req.arrival) + thief.cts[j]
            if new_finish >= c.finish:
                return
            victim.unqueue_tail(c)
            thief.commit(c.req, c.earliest_possible, stolen=True)
            self.steals += 1

    # --------------------------------------------------------- execution
    def _oracle(self, req: Request) -> int:
        """Python-bigint product, signed-corrected to the bank's output
        width when the design is signed."""
        ia = L.from_limbs(np.asarray(req.a, np.uint32))
        ib = L.from_limbs(np.asarray(req.b, np.uint32))
        if self.spec.signed:
            if ia >= 1 << (self.spec.bits_a - 1):
                ia -= 1 << (L.RADIX_BITS * self.design.la)
            if ib >= 1 << (self.spec.bits_b - 1):
                ib -= 1 << (L.RADIX_BITS * self.design.lb)
        width = L.RADIX_BITS * (self.design.la + self.design.lb)
        return (ia * ib) % (1 << width)

    def _execute_round(self, rep: Replica, window_end: int) -> None:
        """Run every commit retiring inside the window as ONE bank round."""
        t0 = time.perf_counter()
        due = []
        for q in rep.queues:
            while q and q[0].finish <= window_end:
                due.append(q.pop(0))
        if not due:
            return
        due.sort(key=lambda c: (c.finish, c.req.rid))
        n = len(due)
        bucket = _bucket(n)
        a = np.zeros((bucket, self.design.la), np.uint32)
        b = np.zeros((bucket, self.design.lb), np.uint32)
        for k, c in enumerate(due):
            a[k] = c.req.a
            b[k] = c.req.b
        packed = time.perf_counter() - t0
        # one copy to the bank's device, one synchronising copy back
        out = rep.bank.execute(L.from_numpy(a, rep.bank.device),
                               L.from_numpy(b, rep.bank.device))
        out = out.cpu().numpy()
        t0 = time.perf_counter()
        self.rounds += 1
        self.max_round_batch = max(self.max_round_batch, n)
        for k, c in enumerate(due):
            rep.busy_cycles[c.instance] += rep.cts[c.instance]
            product = tuple(int(x) for x in out[k])
            if self.check:
                self.n_checked += 1
                if L.from_limbs(out[k]) != self._oracle(c.req):
                    self.n_mismatch += 1
            self.responses[c.req.rid] = Response(
                rid=c.req.rid, admitted=True, arrival=c.req.arrival,
                deadline=c.req.deadline,
                earliest_possible=c.earliest_possible,
                issue=c.issue, finish=c.finish, replica=rep.index,
                instance=c.instance, stolen=c.stolen, product=product)
        telemetry.span("worker.round_host", packed + time.perf_counter() - t0)
        telemetry.count("worker.rows", n)
        telemetry.count("worker.bucket_rows", bucket)

    # -------------------------------------------------------- autoscaling
    def _autoscale(self, window_end: int, n_arrived: int,
                   elapsed: int) -> None:
        live = self._live()
        target = self.autoscaler.observe(window_end, n_arrived, elapsed,
                                         len(live))
        if target > len(live):
            for _ in range(target - len(live)):
                # un-drain a held replica before building a new one
                held = next((r for r in self.replicas
                             if r.draining and not r.retired), None)
                if held is not None:
                    held.draining = False
                else:
                    self.replicas.append(
                        self._new_replica(len(self.replicas)))
        elif target < len(live):
            for rep in sorted(live, key=lambda r: -r.index)[
                    :len(live) - target]:
                rep.draining = True

    def _retire_drained(self) -> None:
        for rep in self.replicas:
            if rep.draining and not rep.retired and rep.pending() == 0:
                rep.retired = True

    # -------------------------------------------------------------- loop
    def run(self, requests) -> ServingReport:
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        if not reqs:
            raise ValueError("no requests to serve")
        self.responses = {}
        t0 = time.perf_counter()
        now = reqs[0].arrival
        i = 0
        self._timeline = [(now, len(self._live()))]
        while i < len(reqs) or any(r.pending() for r in self.replicas):
            window_end = now + self.round_cycles
            batch = []
            while i < len(reqs) and reqs[i].arrival < window_end:
                batch.append(reqs[i])
                i += 1
            # EDF among simultaneous arrivals: a tight-deadline request
            # in a burst claims its slot before lax ones
            t_admit = time.perf_counter()
            batch.sort(key=lambda r: (r.arrival, r.deadline, r.rid))
            for req in batch:
                self._admit(req)
            if self.steal and len(self._live()) > 1:
                self._steal_pass(now)
            telemetry.span("worker.admit", time.perf_counter() - t_admit)
            for rep in self.replicas:
                self._execute_round(rep, window_end)
            self._retire_drained()
            if self.autoscaler is not None:
                self._autoscale(window_end, len(batch), self.round_cycles)
                if self._timeline[-1][1] != len(self._live()):
                    self._timeline.append((window_end, len(self._live())))
            now = window_end
            if i < len(reqs) and not any(r.pending() for r in self.replicas) \
                    and reqs[i].arrival > now:
                now = reqs[i].arrival        # fast-forward an idle fleet
        wall = time.perf_counter() - t0
        return self._report(reqs, wall)

    # ------------------------------------------------------------ report
    def _report(self, reqs, wall: float) -> ServingReport:
        rs = [self.responses[r.rid] for r in reqs]
        admitted = [r for r in rs if r.admitted]
        met = [r for r in admitted if r.met_deadline]
        first = min(r.arrival for r in reqs)
        last = max([r.finish for r in admitted]
                   + [r.arrival for r in reqs])
        horizon = max(last - first, 1)
        hist = latency_histogram(r.latency for r in admitted)
        util = tuple(
            tuple(b / horizon for b in rep.busy_cycles)
            for rep in self.replicas)
        return ServingReport(
            design=self.plan.describe(),
            n_requests=len(rs),
            n_admitted=len(admitted),
            n_refused=len(rs) - len(admitted),
            n_completed=len(admitted),
            slo_violations=len(admitted) - len(met),
            steals=self.steals,
            rounds=self.rounds,
            max_round_batch=self.max_round_batch,
            horizon_cycles=horizon,
            offered_rate=len(rs) / horizon,
            goodput=len(met) / horizon,
            provisioned_tp=str(Fraction(self.plan.throughput)),
            latency_hist=hist,
            utilization=util,
            replica_timeline=tuple(self._timeline),
            wall_s=wall,
            n_checked=self.n_checked,
            n_mismatch=self.n_mismatch,
        )
