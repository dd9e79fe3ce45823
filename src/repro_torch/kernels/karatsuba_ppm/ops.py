"""Public wrapper for the spatial Karatsuba multiply."""
from __future__ import annotations

import torch

from .kernel import karatsuba_ppm_mul, karatsuba_ppm_mul_ref


def kara_mul(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = True
             ) -> torch.Tensor:
    """(B, N) x (B, N) -> (B, 2N) limbs, N even.

    ``use_kernel=False`` asks for the plain version on any device.
    """
    if not use_kernel:
        return karatsuba_ppm_mul_ref(a, b)
    return karatsuba_ppm_mul(a, b)
