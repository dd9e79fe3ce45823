from .ops import big_mul, vmem_bytes_per_step, batch_tile, launch_contract
from .kernel import (PATHS, fold_launch_plan, mcim_fold_kernel,
                     mcim_fold_karatsuba_kernel,
                     mcim_fold_mul, mcim_fold_mul_ref, fold_geometry,
                     FoldGeometry)

__all__ = ["big_mul", "vmem_bytes_per_step", "batch_tile", "mcim_fold_mul",
           "mcim_fold_mul_ref", "fold_geometry", "FoldGeometry", "PATHS",
           "fold_launch_plan", "mcim_fold_kernel",
           "mcim_fold_karatsuba_kernel", "launch_contract"]
