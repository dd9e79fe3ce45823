"""Bank subsystem: executable multiplier banks for ``planner.Plan``s.

  :mod:`.schedule`  -- dispatch policies (round_robin / greedy /
                       streaming), a static (assignment, makespan) each
  :mod:`.backends`  -- ``InstanceBackend`` registry keyed by
                       (arch, capability): core, kernel or fused
  :mod:`.engine`    -- the ``Bank`` wiring a Plan, a scheduler and
                       backends into bit-exact, cycle-accounted execution
  :mod:`.sharded`   -- N replicated banks over a list of devices
"""
from .schedule import (Scheduler, RoundRobinScheduler, GreedyScheduler,
                       StreamingScheduler, SCHEDULERS, register_scheduler,
                       get_scheduler, round_robin_schedule, greedy_schedule,
                       streaming_schedule, uniform_arrivals,
                       completion_cycles, latency_histogram,
                       histogram_percentile)
from .backends import (InstanceBackend, BACKENDS, CAPABILITIES,
                       register_backend, get_backend, registered_backends,
                       cached_mul)
from .engine import Bank, BankReport, InstanceReport, execute, last_report
from .sharded import sharded_execute, sharded_report

__all__ = [
    "Scheduler", "RoundRobinScheduler", "GreedyScheduler",
    "StreamingScheduler", "SCHEDULERS", "register_scheduler",
    "get_scheduler", "round_robin_schedule", "greedy_schedule",
    "streaming_schedule", "uniform_arrivals",
    "completion_cycles", "latency_histogram", "histogram_percentile",
    "InstanceBackend", "BACKENDS", "CAPABILITIES", "register_backend",
    "get_backend", "registered_backends", "cached_mul",
    "Bank", "BankReport", "InstanceReport", "execute", "last_report",
    "sharded_execute", "sharded_report",
]
