"""Sharded multi-bank execution: TP=3.5 replicated over two devices.

The paper's Sec. V-E bank sustains 3.5 multiplications/cycle on one
chip.  Production serving replicates it: this demo compiles ONE
``DesignSpec`` with ``replicas=2`` over ``--devices`` (the first two
cards by default) -- the facade routes ``mul`` through
``bank.sharded_execute`` so each device executes one full bank replica
on half the batch, and the products come back on the operands' device --
and shows that

  * the gathered results are bit-exact vs Python's bigints (and vs the
    single-replica design),
  * each replica ran on its own device,
  * the aggregate throughput is N_devices x the per-replica rate
    (2 x 3.5 = 7 ops/cycle here),
  * the greedy scheduler's makespan never loses to round-robin.

  PYTHONPATH=src python examples_torch/sharded_bank.py \\
      [--devices cuda:0,cuda:1 | cuda:0,cuda:0 | cpu,cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import designs
from repro_torch.core import limbs as L
from repro_torch.device import resolve_device

BITS = 32
TP = 3.5
BATCH = 56                      # 28 ops per device = 8 hyperperiods each
REPLICAS = 2


def _devices(arg, device):
    """The replicas' devices: ``--devices`` as given, else the first two
    cards (a device repeats only when the caller names it twice)."""
    if arg:
        return [resolve_device(d) for d in arg.split(",")]
    if device is not None and resolve_device(device).type == "cpu":
        raise RuntimeError("the replicas default to the first two cards; "
                           "pass --devices cpu,cpu to run both on the CPU")
    resolve_device(None)               # raises without CUDA
    if torch.cuda.device_count() < REPLICAS:
        raise RuntimeError(
            f"{REPLICAS} replicas need {REPLICAS} cards, this machine has "
            f"{torch.cuda.device_count()}; pass --devices cuda:0,cuda:0 to "
            f"run both replicas on one card")
    return [torch.device("cuda", i) for i in range(REPLICAS)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="comma-separated replica devices (default: the "
                         "first two CUDA cards)")
    ap.add_argument("--device", default=None,
                    help="where the operands lie (default: the first of "
                         "--devices)")
    args = ap.parse_args(argv)
    devices = _devices(args.devices, args.device)
    device = resolve_device(args.device or devices[0])
    n_dev = len(devices)
    spec = designs.DesignSpec(BITS, BITS, TP, replicas=n_dev,
                              mesh_axis="data")
    design = designs.generate(spec, device=device, devices=devices)
    print(f"mesh: {n_dev} devices over axis {spec.mesh_axis!r}")
    print(f"design: {design.describe()}")

    rng = np.random.default_rng(0)
    a = L.random_limbs(rng, (BATCH,), BITS)
    b = L.random_limbs(rng, (BATCH,), BITS)
    ta, tb = L.from_numpy(a, device), L.from_numpy(b, device)

    out = design.mul(ta, tb)
    got = L.batch_from_limbs(out)
    expect = [L.from_limbs(x) * L.from_limbs(y) for x, y in zip(a, b)]
    single = designs.generate(dataclasses.replace(spec, replicas=1),
                              device=device).mul(ta, tb)
    print(f"\nbit-exact over {BATCH} ops: {got == expect}")
    print(f"identical to the single-replica design: "
          f"{torch.equal(out, single)}")
    print(f"replica devices: {', '.join(str(d) for d in design.devices)} "
          f"(products gathered on {out.device})")

    rep = design.report(BATCH)          # per-replica accounting
    print(f"\nper replica: {rep.batch} ops in {rep.cycles} cycles "
          f"-> {rep.measured_throughput} ops/cycle")
    print(f"aggregate: {n_dev} replicas -> "
          f"{design.throughput} ops/cycle "
          f"(plan claims {n_dev} x {rep.plan_throughput})")

    # policy comparison on one replica's shard
    local = BATCH // n_dev
    rr = design.bank.report(local, scheduler="round_robin").cycles
    greedy = design.bank.report(local, scheduler="greedy").cycles
    print(f"\nscheduler makespans on a {local}-op shard: "
          f"round_robin={rr}, greedy={greedy} (greedy never loses)")


if __name__ == "__main__":
    main()
