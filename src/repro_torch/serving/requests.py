"""Requests, responses and synthetic load for online bank serving.

The serving layer's unit of work is one multiplication with a latency
budget: a :class:`Request` carries its operands (limb tuples at the
design's widths), the cycle it enters the system, and the absolute
deadline by which its product must retire.  A :class:`Response` records
what the worker did with it -- the committed issue/finish cycles and
the product limbs for admitted requests, or the refusal evidence
(``earliest_possible``, the best completion any instance could have
offered) for refused ones, so admission control is auditable after the
fact: a refusal is only ever justified by ``earliest_possible >
deadline``.

Synthetic load generators produce the arrival shapes sustained traffic
actually has (all seeded, all in integer bank cycles):

  ``poisson_arrivals``   memoryless arrivals at a mean rate -- the
                         baseline open-loop load model;
  ``bursty_arrivals``    whole bursts land on one cycle (a serving
                         engine's grouped prefills look like this),
                         spaced to hold the same mean rate;
  ``diurnal_arrivals``   sinusoidally modulated Poisson rate -- the
                         millions-of-users day/night envelope an
                         autoscaler must track.

``synthesize`` turns any arrival trace into concrete requests with
random operands, round-robined over multi-tenant width classes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import limbs as L


@dataclasses.dataclass(frozen=True)
class Request:
    """One multiplication with a latency budget (all cycles absolute)."""
    rid: int
    arrival: int                # cycle the request enters the system
    deadline: int               # absolute retire-by cycle (SLO)
    a: tuple                    # operand A limbs (len LA, uint32 values)
    b: tuple                    # operand B limbs (len LB)
    bits_a: int = 0             # width class (0 = the design's width)
    bits_b: int = 0
    tenant: int = 0             # tenant the width class belongs to

    @property
    def budget(self) -> int:
        """Latency budget in cycles (deadline relative to arrival)."""
        return self.deadline - self.arrival

    def oracle(self) -> int:
        """The Python-bigint product every response is checked against."""
        return L.from_limbs(np.asarray(self.a, np.uint32)) * \
            L.from_limbs(np.asarray(self.b, np.uint32))


@dataclasses.dataclass(frozen=True)
class Response:
    """What the worker did with one request."""
    rid: int
    admitted: bool
    arrival: int
    deadline: int
    #: best completion cycle ANY live instance could have offered at
    #: decision time: the admission proof (admitted => <= deadline) and
    #: the refusal evidence (refused => > deadline)
    earliest_possible: int
    issue: int = -1             # committed start cycle (admitted only)
    finish: int = -1            # committed retire cycle (admitted only)
    replica: int = -1           # replica that executed it
    instance: int = -1          # instance index within that replica
    stolen: bool = False        # rebalanced off its home replica's queue
    product: tuple = ()         # (LA+LB) product limbs

    @property
    def latency(self) -> int:
        """End-to-end cycles from arrival to retire (-1 if refused)."""
        return self.finish - self.arrival if self.admitted else -1

    @property
    def met_deadline(self) -> bool:
        return self.admitted and self.finish <= self.deadline


# ------------------------------------------------------------ load shapes

def poisson_arrivals(n: int, rate: float, seed: int = 0) -> tuple:
    """``n`` Poisson arrivals at ``rate`` requests/cycle (mean)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return tuple(int(c) for c in np.floor(np.cumsum(gaps)))


def bursty_arrivals(n: int, rate: float, seed: int = 0,
                    burst: int = 8) -> tuple:
    """Bursts of ``burst`` simultaneous arrivals at mean ``rate``.

    Burst instants are Poisson at ``rate / burst``, so the mean request
    rate matches ``poisson_arrivals`` while the instantaneous rate is
    ``burst`` times spikier -- the worst case for per-replica queues
    (and the case work stealing exists for).
    """
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    n_bursts = -(-n // burst)
    instants = poisson_arrivals(n_bursts, rate / burst, seed)
    out = [c for c in instants for _ in range(burst)]
    return tuple(out[:n])


def diurnal_arrivals(n: int, rate: float, seed: int = 0,
                     period: int = 512, depth: float = 0.8) -> tuple:
    """Sinusoidally modulated Poisson arrivals (mean ``rate``).

    The instantaneous rate is ``rate * (1 + depth*sin(2*pi*t/period))``:
    a day/night envelope squeezed into ``period`` cycles, peaking at
    ``(1+depth)x`` the mean -- the trace an autoscaler must follow up
    AND back down.
    """
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    rng = np.random.default_rng(seed)
    out = []
    t = 0
    while len(out) < n:
        inst = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        k = rng.poisson(max(inst, 0.0))
        out.extend([t] * int(k))
        t += 1
    return tuple(out[:n])


# --------------------------------------------------------------- requests

def synthesize(arrivals, bits_a: int, bits_b: int, budget: int, *,
               seed: int = 0, width_classes=None) -> tuple:
    """Concrete requests for an arrival trace: random operands, fixed
    latency budget, width classes round-robined over tenants.

    ``bits_a``/``bits_b`` are the serving design's operand widths;
    ``width_classes`` optionally lists per-tenant ``(wa, wb)`` pairs no
    wider than the design (narrow tenants' operands are generated at
    their own width and zero-extend into the design's limbs, so one
    bank serves every tenant bit-exactly).  ``budget`` is the SLO in
    cycles: ``deadline = arrival + budget``.
    """
    arrivals = tuple(int(c) for c in arrivals)
    if any(y < x for x, y in zip(arrivals, arrivals[1:])):
        raise ValueError("arrival trace must be nondecreasing")
    if budget < 1:
        raise ValueError(f"budget must be >= 1 cycle, got {budget}")
    classes = tuple(width_classes or ((bits_a, bits_b),))
    for wa, wb in classes:
        if wa > bits_a or wb > bits_b:
            raise ValueError(
                f"width class {wa}x{wb} exceeds the design's "
                f"{bits_a}x{bits_b}")
    rng = np.random.default_rng(seed)
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    out = []
    for rid, arr in enumerate(arrivals):
        tenant = rid % len(classes)
        wa, wb = classes[tenant]
        a = np.zeros((la,), np.uint32)
        b = np.zeros((lb,), np.uint32)
        a[:L.n_limbs_for_bits(wa)] = L.random_limbs(rng, (), wa)
        b[:L.n_limbs_for_bits(wb)] = L.random_limbs(rng, (), wb)
        out.append(Request(rid=rid, arrival=arr, deadline=arr + budget,
                           a=tuple(int(x) for x in a),
                           b=tuple(int(x) for x in b),
                           bits_a=wa, bits_b=wb, tenant=tenant))
    return tuple(out)
