"""Fused bank kernel: a whole plan round in one CUDA launch."""
from .geometry import (FUSED_SCHEDULE, SuperGeometry, fused_ct,
                       fused_geometry, fused_windows, super_geometry,
                       vmem_bytes_per_step)
from .kernel import (PATHS, fused_bank_mul, fused_bank_mul_kernel,
                     fused_bank_mul_ref, fused_bank_rows, launch_plan)
from .ops import (fused_block_rows, fused_owner, launch_contract,
                  make_fused_dispatch)

__all__ = [
    "FUSED_SCHEDULE", "SuperGeometry", "fused_ct", "fused_geometry",
    "fused_windows", "super_geometry", "vmem_bytes_per_step",
    "PATHS", "fused_bank_mul", "fused_bank_mul_kernel",
    "fused_bank_mul_ref", "fused_bank_rows", "launch_plan",
    "fused_block_rows", "fused_owner", "launch_contract",
    "make_fused_dispatch",
]
