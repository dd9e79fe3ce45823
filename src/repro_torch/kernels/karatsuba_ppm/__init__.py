from .kernel import (BULK_N, PATHS, karatsuba_ppm_kernel, karatsuba_ppm_mul,
                     karatsuba_ppm_mul_ref, launch_plan)
from .ops import kara_mul, launch_contract

__all__ = ["karatsuba_ppm_mul", "karatsuba_ppm_mul_ref", "kara_mul",
           "karatsuba_ppm_kernel", "launch_plan", "PATHS", "BULK_N",
           "launch_contract"]
