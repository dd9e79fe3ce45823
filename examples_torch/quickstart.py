"""Quickstart: the paper's design generator as a PyTorch library.

One declarative ``DesignSpec`` -- throughput, clock target, latency
budget, signedness -- compiles into an executable ``CompiledDesign``
via ``repro_torch.designs.generate``.  No planner/bank hand-wiring.  On
the card (the default) every round is one ``bank_fold`` kernel launch.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
from fractions import Fraction

from repro_torch import autotune, designs
from repro_torch.core import planner
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)

    # -- multiply two 128-bit integers through generated designs ---------
    a = 0xDEADBEEF_CAFEBABE_01234567_89ABCDEF
    b = 0xFEEDFACE_8BADF00D_00C0FFEE_DEADC0DE
    print("one 128x128 multiply per throughput point:")
    for tp in (1, Fraction(1, 2), Fraction(1, 3)):
        d = designs.generate(designs.DesignSpec(128, 128, tp), device=device)
        ok = "OK " if d.mul(a, b) == a * b else "FAIL"
        print(f"  {ok} TP={tp!s:4} -> {d.plan.describe()}")

    # -- clock-frequency customization (the paper's strict tables) -------
    # a 0.31 ns target rejects the feedback-loop design the relaxed
    # planner would pick; generate() falls back per timing_model
    relaxed = designs.generate(designs.DesignSpec(32, 32, Fraction(1, 3)),
                               device=device)
    tight = designs.generate(
        designs.DesignSpec(32, 32, Fraction(1, 3), clock_ns=0.31),
        device=device)
    print(f"\nrelaxed pick : {relaxed.plan.describe()}")
    print(f"0.31ns pick  : {tight.plan.describe()} "
          f"(fallback={tight.timing_fallback})")
    print(f"  latency {tight.latency_cycles} cycles, "
          f"fmax ~{tight.fmax_estimate:.2f} GHz, "
          f"area {tight.area:.0f} um2 (incl. synthesis stress), "
          f"energy {tight.energy_per_op_pj:.2f} pJ/op, "
          f"peak {tight.peak_power_mw:.2f} mW")

    # -- energy/peak-power model + autotuner (paper Sec. V headlines) ----
    front = autotune.search(designs.DesignSpec(32, 32, Fraction(1, 3)))
    print(f"\nPareto front over every TP=1/3 decomposition "
          f"({len(front)} non-dominated of "
          f"{len(front.front) + len(front.dominated)}):")
    for c in front:
        print(f"  {c.describe()}")
    low = front.best("energy").compile(device=device)
    print(f"best-energy point compiles + multiplies exactly: "
          f"{low.mul(a % 2**32, b % 2**32) == (a % 2**32) * (b % 2**32)}")
    lp = designs.generate("tbl8_w32_lowpower", device=device)
    print(f"registered low-power design: {lp.describe()}")

    # -- fractional-throughput planning (use case 1, Sec. V-E) -----------
    d = designs.generate("tp3p5_w32", device=device)   # registered point
    conv = planner.star_bank_area(32, 32, 3.5)
    print(f"\nTP=3.5 multipliers/cycle: {d.plan.describe()}")
    print(f"  vs conventional 4x Star bank: saves {1 - d.area / conv:.0%}")

    # -- lossless provenance ---------------------------------------------
    blob = d.to_json()
    again = designs.generate(designs.DesignSpec.from_json(blob),
                             device=device)
    print(f"\nspec json round-trip recompiles bit-exactly: "
          f"{again.mul(a % 2**32, b % 2**32) == d.mul(a % 2**32, b % 2**32)}")


if __name__ == "__main__":
    main()
