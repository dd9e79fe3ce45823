#!/usr/bin/env python3
"""Does ``torch.profiler`` still see device events after a long trace?

    python3 scripts/profiler_probe.py       # on a machine with a card

Counts the port's own kernel launches of one fused ``tp3p5_w32`` round
(``repro_torch.launch.roofline.count_kernel_launches``) and every device
event the profiler records, before and after ``chip_smoke.py``'s phase
10 (training, whose profiled steps trace ~400,000 kernels with CUDA
activity only), in one process.  It prints one line each time.
"""
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C                                  # noqa: E402
from repro_torch import designs                          # noqa: E402
from repro_torch.launch.roofline import count_kernel_launches  # noqa: E402


def probe(label, fn, *args):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    seen = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    print(f"{label}: count_kernel_launches {count_kernel_launches(fn, *args)}"
          f", device events of any kernel {seen}", flush=True)


def main():
    smi = C.phase_card()
    dev = torch.device("cuda", 0)
    design = designs.generate("tp3p5_w32")
    a, b = C.operands(np.random.default_rng(1), (65_536,), 32, dev)
    probe("before phase 10", design.mul, a, b)
    C.phase_training(dev, smi)
    probe("after phase 10", design.mul, a, b)


if __name__ == "__main__":
    main()
