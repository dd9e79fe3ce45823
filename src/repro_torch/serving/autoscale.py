"""Replica autoscaling: track offered load against provisioned TP.

The :class:`Autoscaler` is a deliberately small control loop in the
Kubernetes-HPA shape: each dispatch window the worker reports how many
requests arrived, the controller folds that into an EMA of the offered
rate (requests/cycle), and the replica target is the smallest fleet
whose aggregate provisioned throughput -- ``replicas x Plan.throughput``
per-replica ops/cycle -- covers the smoothed rate at the configured
utilization ceiling.

Asymmetric response, because the failure modes are asymmetric:

  * **scale-up is immediate** -- under-provisioning turns directly into
    refusals (the admission controller starts proving deadlines
    infeasible), so the first window the EMA crosses the ceiling grows
    the fleet;
  * **scale-down waits out ``patience`` consecutive low windows** --
    tearing a replica down on one quiet window flaps under bursty and
    diurnal load, and a draining replica still has committed work.

Beyond replica count, :meth:`Autoscaler.recommend` closes the loop with
the autotuner: when the *sustained* rate sits below the provisioned
per-replica throughput, the cheaper answer than "run fewer replicas of
a big design" is often "run a smaller design" -- so the controller can
consult a :class:`repro_torch.autotune.ParetoFront` for the cheapest design
point whose throughput still covers the observed rate.
"""
from __future__ import annotations

import math

__all__ = ["Autoscaler"]


class Autoscaler:
    """EMA-rate replica controller with hysteresis.

    ``provisioned_tp`` is ONE replica's ``Plan.throughput`` in ops/cycle
    (Fraction or float).  ``target_utilization`` is the fill ceiling a
    replica is sized to (0.85 = keep 15% headroom for bursts);
    ``patience`` is how many consecutive windows the target must sit
    below the live count before a replica is actually drained.
    """

    def __init__(self, provisioned_tp, *, min_replicas: int = 1,
                 max_replicas: int = 8, target_utilization: float = 0.85,
                 ema: float = 0.3, patience: int = 3):
        tp = float(provisioned_tp)
        if tp <= 0:
            raise ValueError(f"provisioned_tp must be positive, got {tp}")
        if not 0.0 < target_utilization <= 1.0:
            raise ValueError("target_utilization must be in (0, 1]")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.provisioned_tp = tp
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.target_utilization = target_utilization
        self.ema = ema
        self.patience = patience
        self.rate = 0.0           # EMA of offered requests/cycle
        self._low_windows = 0

    def _clamp(self, n: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, n))

    def desired(self) -> int:
        """Smallest fleet covering the EMA rate at the fill ceiling."""
        if self.rate <= 0.0:
            return self.min_replicas
        need = self.rate / (self.provisioned_tp * self.target_utilization)
        return self._clamp(math.ceil(need))

    def observe(self, cycle: int, n_arrivals: int, elapsed_cycles: int,
                live: int) -> int:
        """Fold one dispatch window into the EMA; return the replica
        target the worker should converge to.

        Scale-up targets apply immediately; scale-down targets are held
        at ``live`` until ``patience`` consecutive windows agree.
        """
        inst = n_arrivals / max(elapsed_cycles, 1)
        self.rate += self.ema * (inst - self.rate)
        target = self.desired()
        if target >= live:
            self._low_windows = 0
            return target
        self._low_windows += 1
        if self._low_windows >= self.patience:
            self._low_windows = 0
            return target
        return live

    def recommend(self, front, objective: str = "area"):
        """Cheapest autotuner design point still covering the sustained
        rate, or None when the front has no feasible point.

        Consulted when the EMA rate sits below one replica's provisioned
        throughput: rather than idling a big design, re-plan onto the
        ``ParetoFront`` point with the least ``objective`` (area by
        default) whose per-replica throughput >= the observed rate.
        """
        if self.rate >= self.provisioned_tp:
            return None            # load fills the current design: keep it
        return front.best_meeting(self.rate, objective)

    def describe(self) -> str:
        return (f"Autoscaler[rate={self.rate:.4f}/cy "
                f"tp={self.provisioned_tp:.4f}/cy/replica "
                f"target={self.desired()} "
                f"range=[{self.min_replicas},{self.max_replicas}]]")
