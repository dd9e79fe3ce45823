"""Sharded multi-bank execution: N replicated banks over a list of devices.

Counterpart of the reference's ``core/bank/sharded.py``.  The paper's
Sec. V-E bank sustains a fractional throughput on one chip; production
serving replicates that bank across devices.  Here the reference's mesh
axis is a sequence of ``torch.device``s, one per replica (a device may
repeat: ``["cpu"] * 2`` on the CPU, ``[cuda:0, cuda:0]`` on one card).
The global batch is split into equal shards, each shard is copied to its
replica's device and runs through a full :class:`Bank` built there (the
same scheduler and backend as a single bank), and the products come back
concatenated on the operands' device.  Each multiplication is computed
by exactly one instance of one replica, so ``sharded_execute`` equals
the single-bank oracle product for product.
"""
from __future__ import annotations

import functools

import torch

from .. import limbs as L
from ..planner import Plan
from .engine import Bank, BankReport
from repro_torch.device import resolve_device


def _local_batch(batch: int, devices, axis: str) -> int:
    """The shard size, after the reference's ``bank_batch_spec`` checks:
    bank replicas each need an equal shard, so a batch that does not
    divide is an error, not a fallback."""
    if not devices:
        raise ValueError(f"axis {axis!r} has no devices")
    if batch % len(devices):
        raise ValueError(
            f"batch {batch} not divisible by mesh axis {axis!r} size "
            f"{len(devices)}")
    return batch // len(devices)


@functools.lru_cache(maxsize=64)
def _replica_bank(plan: Plan, bits_a: int, bits_b: int, backend: str,
                  scheduler: str, device: torch.device, local: int) -> Bank:
    # cached per (plan, widths, backend, scheduler, device, shard size),
    # as the reference caches its compiled sharded dispatch
    return Bank(plan, bits_a, bits_b, backend=backend, scheduler=scheduler,
                device=device)


def _replica_banks(plan: Plan, bits_a: int, bits_b: int, devices, local: int,
                  *, backend: str = "core",
                  scheduler: str = "round_robin") -> list:
    """One :class:`Bank` a replica, each on its device (cached)."""
    return [_replica_bank(plan, bits_a, bits_b, backend, scheduler,
                          resolve_device(d), local) for d in devices]


def sharded_execute(plan: Plan, a: torch.Tensor, b: torch.Tensor, devices,
                    *, backend: str = "core", scheduler: str = "round_robin",
                    axis: str = "data") -> torch.Tensor:
    """Replicated-bank execution of (B, LA) x (B, LB) over ``devices``.

    Each of the ``len(devices)`` replicas runs one full bank on its B/N
    shard; the returned (B, LA+LB) int32 limb products, on the operands'
    device, are bit-exact against the single-bank (and Python-bigint)
    oracle.  The global batch must divide evenly; ``axis`` names the
    device list in errors (the spec's ``mesh_axis``).
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("sharded_execute expects batched (B, L) operands")
    if a.shape[0] != b.shape[0]:
        raise ValueError(
            f"batch mismatch: a has {a.shape[0]} ops, b has {b.shape[0]}")
    local = _local_batch(a.shape[0], devices, axis)
    banks = _replica_banks(plan, a.shape[-1] * L.RADIX_BITS,
                          b.shape[-1] * L.RADIX_BITS, devices, local,
                          backend=backend, scheduler=scheduler)
    outs = [bank.execute(a[i * local:(i + 1) * local].to(bank.device),
                         b[i * local:(i + 1) * local].to(bank.device))
            for i, bank in enumerate(banks)]
    return torch.cat([out.to(a.device) for out in outs])


def sharded_report(plan: Plan, batch: int, bits_a: int, bits_b: int,
                   devices, *, backend: str = "core",
                   scheduler: str = "round_robin",
                   axis: str = "data") -> BankReport:
    """Per-replica cycle accounting: the report of one bank running its
    B/N shard (all replicas are identical, so one report describes the
    whole sharded execution; aggregate throughput is N x measured)."""
    local = _local_batch(batch, devices, axis)
    bank, = _replica_banks(plan, bits_a, bits_b, devices[:1], local,
                          backend=backend, scheduler=scheduler)
    return bank.report(local)
