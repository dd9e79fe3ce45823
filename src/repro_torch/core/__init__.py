"""Core MCIM library in PyTorch: multi-cycle folded integer multipliers.

Most callers start one level up, at :mod:`repro_torch.designs`.  The
layers below stay public for direct use:

  limbs            -- limb representation + PPM / compressor / final adders
  mcim_mul         -- configurable folded multiply (star/fb/ff/karatsuba)
  MCIMConfig       -- generator parameters (arch, ct, levels, adder, signed)
  planner          -- design-point selection (paper Table VIII policy)
  timing_model     -- clock/latency model filtering that selection
  area_model       -- ASIC-area cost model
  power_model      -- switching-energy / peak-power cost model
  bank             -- executable multiplier banks for planner Plans
"""
from . import limbs
from .mcim import MCIMConfig, mcim_mul, make_multiplier, mul32x32_64
from .schoolbook import star_mul, feedback_mul, feedforward_mul
from .karatsuba import karatsuba_mul, karatsuba_ppm
from . import area_model
from . import timing_model
from . import power_model
from . import planner
from . import bank
from .bank import Bank, BankReport, sharded_execute

__all__ = [
    "limbs", "area_model", "timing_model", "power_model", "planner", "bank",
    "Bank", "BankReport", "sharded_execute",
    "MCIMConfig", "mcim_mul", "make_multiplier", "mul32x32_64",
    "star_mul", "feedback_mul", "feedforward_mul",
    "karatsuba_mul", "karatsuba_ppm",
]
