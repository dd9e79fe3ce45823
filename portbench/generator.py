"""The traffic generator: the one reader of the mix files in ``traffic/``.

A mix file is JSON.  Its ``entry`` names the call the window drives:

* ``"mul"``: back-to-back ``CompiledDesign.mul`` calls on device batches
  of ``batch`` operand pairs, from a pool of distinct batches of at least
  ``pool_bytes`` of operands, used in turn (:func:`operand_pool`);
* ``"serve"``: back-to-back ``CompiledDesign.serve`` calls, each on a
  trace of ``requests`` requests from a pool of ``traces`` traces
  (:func:`serve_traces`): Poisson arrivals at ``load`` x the plan's
  throughput, a budget of ``max(budget_ct_factor x the plan's longest
  CT, ceil(budget_cycles_per_tp / TP))`` cycles.

The drivers (``drivers/<entry>.py``) read the rest of a mix:
``sample_rows`` and ``warmup_calls`` (mul), ``replicas`` and
``warmup_passes`` (serve).

Every seed gets the same arrival traces (drawn from the mix's
``shape_seed``) and the same sizes; the run's seed draws the operands
and the order in which the traces are served.  The arrival and request
synthesis below are frozen copies of ``repro_torch/serving/requests.py``
(``poisson_arrivals``, ``synthesize``) and of the
limb helpers they use, so that a change to the program cannot change
the traffic it is measured on.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RADIX_BITS = 16
RADIX = 1 << RADIX_BITS


def n_limbs_for_bits(bits: int) -> int:
    return -(-bits // RADIX_BITS)


def random_limbs(rng: np.random.Generator, shape, bits: int) -> np.ndarray:
    """Uniform ``bits``-bit integers as uint32 limb arrays."""
    n = n_limbs_for_bits(bits)
    out = rng.integers(0, RADIX, size=tuple(shape) + (n,), dtype=np.uint32)
    rem = bits - (n - 1) * RADIX_BITS
    out[..., -1] &= (1 << rem) - 1
    return out


# ------------------------------------------------------------ load shapes

def poisson_arrivals(n: int, rate: float, seed=0) -> tuple:
    """``n`` Poisson arrivals at ``rate`` requests/cycle (mean)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return tuple(int(c) for c in np.floor(np.cumsum(gaps)))


def synthesize(arrivals, bits_a: int, bits_b: int, budget: int, *,
               seed=0) -> tuple:
    """Requests for an arrival trace as plain tuples ``(rid, arrival,
    deadline, a_limbs, b_limbs)``: random full-width operands, one
    latency budget (the single-tenant case of the program's
    ``synthesize``, drawing the same numbers)."""
    arrivals = tuple(int(c) for c in arrivals)
    if any(y < x for x, y in zip(arrivals, arrivals[1:])):
        raise ValueError("arrival trace must be nondecreasing")
    if budget < 1:
        raise ValueError(f"budget must be >= 1 cycle, got {budget}")
    rng = np.random.default_rng(seed)
    out = []
    for rid, arr in enumerate(arrivals):
        a = tuple(int(x) for x in random_limbs(rng, (), bits_a))
        b = tuple(int(x) for x in random_limbs(rng, (), bits_b))
        out.append((rid, arr, arr + budget, a, b))
    return tuple(out)


# ----------------------------------------------------------------- mixes

def unsigned_seed(seed: int) -> int:
    """The run's seed as numpy and torch both take it."""
    return seed % (1 << 63)


def operand_pool(mix: dict, bits_a: int, bits_b: int, seed: int,
                 device) -> tuple:
    """``(a, b)``: int32 limb tensors ``(slots, batch, la)`` and ``(slots,
    batch, lb)`` drawn on ``device`` from the seed, in one call each."""
    batch = int(mix["batch"])
    la, lb = n_limbs_for_bits(bits_a), n_limbs_for_bits(bits_b)
    slots = math.ceil(int(mix["pool_bytes"]) / (batch * (la + lb) * 4))
    gen = torch.Generator(device=device)
    gen.manual_seed(unsigned_seed(seed))
    pool = []
    for bits, limbs in ((bits_a, la), (bits_b, lb)):
        x = torch.randint(0, RADIX, (slots, batch, limbs), generator=gen,
                          device=device, dtype=torch.int32)
        rem = bits - (limbs - 1) * RADIX_BITS
        if rem < RADIX_BITS:
            x[..., -1] &= (1 << rem) - 1
        pool.append(x)
    return tuple(pool)


def budget_cycles(mix: dict, tp: float, max_ct: int) -> int:
    return max(int(mix["budget_ct_factor"]) * max_ct,
               math.ceil(float(mix["budget_cycles_per_tp"]) / tp))


def serve_traces(mix: dict, bits_a: int, bits_b: int, tp: float,
                 max_ct: int, seed: int) -> list:
    """The pool of request traces, in the order the seed serves them:
    each a tuple of ``synthesize`` rows."""
    n, count = int(mix["requests"]), int(mix["traces"])
    budget = budget_cycles(mix, tp, max_ct)
    shapes = [poisson_arrivals(n, float(mix["load"]) * tp,
                               seed=int(mix["shape_seed"]) + t)
              for t in range(count)]
    seed = unsigned_seed(seed)
    order = np.random.default_rng([seed, count]).permutation(count)
    return [synthesize(shapes[t], bits_a, bits_b, budget, seed=[seed, k])
            for k, t in enumerate(order)]
