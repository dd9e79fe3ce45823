"""Fractional throughput, executed: the paper's TP=3.5 use case (Sec. V-E).

An application needs 3.5 multiplications per cycle.  The conventional
bank rounds up to 4 Star multipliers; ``designs.generate`` instead
compiles 3 Star + one CT=2 folded MCIM from one declarative spec.  This
demo *runs* that design on a real batch (one ``bank_fold`` kernel launch
on the card) and shows that

  * the results are bit-exact vs Python's bigints,
  * the round-robin schedule sustains exactly 3.5 ops/cycle,
  * the design costs less area (ASIC model) and a smaller working set
    (the paper's silicon model) than the 4x Star bank.

  PYTHONPATH=src python examples_torch/fractional_throughput.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import designs
from repro_torch.core import bank, planner
from repro_torch.core import limbs as L
from repro_torch.device import resolve_device
from repro_torch.kernels.mcim_fold import vmem_bytes_per_step

BITS = 32
TP = 3.5
BATCH = 56                      # 16 hyperperiods of 7 ops / 2 cycles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    design = designs.generate(designs.DesignSpec(BITS, BITS, TP),
                              device=device)
    print(f"design: {design.describe()}")

    rng = np.random.default_rng(0)
    a = L.random_limbs(rng, (BATCH,), BITS)
    b = L.random_limbs(rng, (BATCH,), BITS)

    out = design.mul(L.from_numpy(a, device), L.from_numpy(b, device))
    got = L.batch_from_limbs(out)
    expect = [L.from_limbs(x) * L.from_limbs(y) for x, y in zip(a, b)]
    print(f"bit-exact over {BATCH} ops: {got == expect}")

    rep = design.report(BATCH)
    print(f"\nschedule: {BATCH} ops in {rep.cycles} cycles "
          f"-> {rep.measured_throughput} ops/cycle "
          f"(design claims {design.throughput}, "
          f"utilization {rep.utilization:.3f})")
    for i, ir in enumerate(rep.instances):
        print(f"  instance {i}: {ir.config.arch}(ct={ir.ct})  "
              f"{ir.n_ops} ops, busy {ir.busy_cycles} cycles")

    # pluggable dispatch: same design, three scheduling policies
    print("\nscheduler makespans for this batch:")
    for name in ("round_robin", "greedy", "streaming"):
        makespan = design.bank.report(BATCH, scheduler=name).cycles
        print(f"  {name:12s} {makespan} cycles")
    _, tail = bank.greedy_schedule((1, 3), 2)
    _, tail_rr = bank.round_robin_schedule((1, 3), 2)
    print(f"  (on a heterogeneous tail, cts=(1,3) x 2 ops: "
          f"round_robin={tail_rr}, greedy={tail})")

    conv_area = planner.star_bank_area(BITS, BITS, TP)
    print(f"\narea: design {design.area:.0f}um2 vs 4x Star "
          f"{conv_area:.0f}um2 -> saves {1 - design.area / conv_area:.0%}")
    # the paper's silicon working-set model (BankReport.working_set_bytes),
    # not a memory size of any chip
    la = L.n_limbs_for_bits(BITS)
    star_ws = 4 * vmem_bytes_per_step(la, la, 1, design.bank.tile_b)
    print(f"working set (silicon model): design {rep.working_set_bytes} B "
          f"vs 4x Star {star_ws} B "
          f"-> saves {1 - rep.working_set_bytes / star_ws:.0%}")


if __name__ == "__main__":
    main()
