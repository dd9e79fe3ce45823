"""Public wrapper for the parallel-prefix final adder."""
from __future__ import annotations

import torch

from .kernel import prefix_final_adder, prefix_final_adder_ref


def fast_final_adder(cols: torch.Tensor, use_kernel: bool = True
                     ) -> torch.Tensor:
    """Final adder of (B, W) carry-save columns in log depth.

    ``use_kernel=False`` asks for the plain version on any device.
    """
    if not use_kernel:
        return prefix_final_adder_ref(cols)
    return prefix_final_adder(cols)
