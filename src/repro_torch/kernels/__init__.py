"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  mcim_fold      per-instance folded multipliers (fb / ff / karatsuba)
  bank_fold      a whole bank round in one launch
  prefix_adder   log-depth final adder of carry-save columns
  karatsuba_ppm  spatial one-level Karatsuba multiply
  int8_matmul    int8 x int8 matmul with row/column scales

Sources live in ``repro_torch/csrc``; :mod:`._build` compiles them on
first use and keeps the launch counters.  Each launch is a
``torch.library`` custom op (``repro_torch::<kernel>``) with a fake
version, and each package's ``launch_contract`` hook declares its
launches (:mod:`.introspect`) for the plan-time gate
(:mod:`repro_torch.verify.dataflow`).
"""
from ._build import launch_counts, reset_launch_counts
from . import mcim_fold
from . import bank_fold
from . import int8_matmul
from . import karatsuba_ppm
from . import prefix_adder

__all__ = ["launch_counts", "reset_launch_counts", "mcim_fold", "bank_fold",
           "int8_matmul", "karatsuba_ppm", "prefix_adder"]
