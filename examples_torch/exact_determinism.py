"""MCIM fixed-point reductions: bit-exact, order-invariant accumulation.

  PYTHONPATH=src python examples_torch/exact_determinism.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exact import exact_sum


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(100_000).astype(np.float32)
    fwd = torch.from_numpy(x).to(device)
    rev = torch.from_numpy(x[::-1].copy()).to(device)

    f32_fwd = float(torch.sum(fwd))
    f32_rev = float(torch.sum(rev))
    ex_fwd = float(exact_sum(fwd))
    ex_rev = float(exact_sum(rev))

    print(f"f32 sum   forward: {f32_fwd:.10f}")
    print(f"f32 sum   reversed: {f32_rev:.10f}   equal: {f32_fwd == f32_rev}")
    print(f"MCIM sum  forward: {ex_fwd:.10f}")
    print(f"MCIM sum  reversed: {ex_rev:.10f}   equal: {ex_fwd == ex_rev}")
    assert ex_fwd == ex_rev, "exact path must be order-invariant"
    print("\n128-bit fixed-point accumulation is bit-exact under any "
          "reduction order -> reproducible distributed training.")


if __name__ == "__main__":
    main()
