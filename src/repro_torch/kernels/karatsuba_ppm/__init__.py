from .kernel import karatsuba_ppm_mul, karatsuba_ppm_mul_ref
from .ops import kara_mul

__all__ = ["karatsuba_ppm_mul", "karatsuba_ppm_mul_ref", "kara_mul"]
