"""Online multi-tenant bank serving: SLO admission, stealing, autoscale.

The port's copy of the reference package's ``serving``; its banks run
on the design's device (the H100 by default, ``device="cpu"`` for the
plain path).

The offline layers answer "how fast is this design on a batch?"; this
package answers the production question: *under sustained multi-tenant
load, which requests meet their latency SLO, and at what fleet size?*

  :mod:`.requests`   -- Request/Response records plus seeded synthetic
                        load (Poisson, bursty, diurnal traces) and
                        multi-tenant width classes.
  :mod:`.slo`        -- the ``slo_edf`` Scheduler (EDF, registered with
                        the core scheduler family and swept by the
                        verifier contracts) and the admission-control
                        predicates: refuse iff provably infeasible.
  :mod:`.worker`     -- the event loop: admit -> batch into bank rounds
                        (one ``bank_fold`` launch per round) -> dispatch
                        -> complete, with per-replica queues and work
                        stealing for ragged bursts.
  :mod:`.autoscale`  -- EMA replica controller against provisioned
                        ``Plan.throughput``, with a ParetoFront hook
                        recommending cheaper design points under
                        sustained low load.

Importing this package registers ``slo_edf`` in the port's
``core.bank.schedule.SCHEDULERS`` (so ``DesignSpec(scheduler="slo_edf")``
compiles and ``verify.contracts.check_all_schedulers`` sweeps it).  The high-level
entry point is ``CompiledDesign.serve(...)``.
"""
from .requests import (Request, Response, poisson_arrivals, bursty_arrivals,
                       diurnal_arrivals, synthesize)
from .slo import (SLOScheduler, SLO_SCHEDULER, NO_DEADLINE, edf_schedule,
                  earliest_completion, admissible)
from .worker import Worker, Replica, ServingReport
from .autoscale import Autoscaler

__all__ = [
    "Request", "Response", "poisson_arrivals", "bursty_arrivals",
    "diurnal_arrivals", "synthesize",
    "SLOScheduler", "SLO_SCHEDULER", "NO_DEADLINE", "edf_schedule",
    "earliest_completion", "admissible",
    "Worker", "Replica", "ServingReport",
    "Autoscaler",
]
