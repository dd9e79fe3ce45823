"""Public wrapper for the spatial Karatsuba multiply."""
from __future__ import annotations

import torch

from .kernel import karatsuba_ppm_mul, karatsuba_ppm_mul_ref, launch_plan


def launch_contract(n: int, batch: int = 256):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    One spatial-Karatsuba launch over a ``batch`` of (N, N) even-limb
    operands on the path :func:`.kernel.launch_plan` takes for aligned
    operands: the bulk walk at 2 limbs, else one block a tile.
    """
    from repro_torch.kernels import introspect
    if n % 2:
        raise ValueError("even limb count required (pad first)")
    path = launch_plan(batch, n, True)
    return introspect.row_tile_contract(
        name=f"karatsuba_ppm[n={n},batch={batch}]", lib="karatsuba_ppm",
        kernel=("karatsuba_ppm_bulk_launch" if path == "bulk"
                else "karatsuba_ppm_launch"),
        path=path, n_inst=1, rows=batch, la=n, lb=n,
        launch_args=(batch, n),
        operands={"a": introspect.Operand((batch, n), "int32"),
                  "b": introspect.Operand((batch, n), "int32")},
        out_shape=(batch, 2 * n), ops=batch * introspect.kara_row_ops(n))


def kara_mul(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = True
             ) -> torch.Tensor:
    """(B, N) x (B, N) -> (B, 2N) limbs, N even.

    ``use_kernel=False`` asks for the plain version on any device.
    """
    if not use_kernel:
        return karatsuba_ppm_mul_ref(a, b)
    return karatsuba_ppm_mul(a, b)
