"""Public wrapper for the parallel-prefix final adder."""
from __future__ import annotations

import torch

from .kernel import prefix_final_adder, prefix_final_adder_ref


def launch_contract(width: int, batch: int = 256):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    One prefix-adder launch over a ``batch`` of ``width``-column int64
    carry-save rows: a segment of lanes a row, the power of two at least
    ``width`` (at most 32; two columns a lane above), 256 threads a
    block, no shared memory.
    """
    from repro_torch.kernels import introspect
    seg = min(32, 1 << (width - 1).bit_length())
    kernel = "prefix_adder_launch"
    grid, block, smem = introspect.launch_shape(kernel, (batch, width))
    return introspect.LaunchContract(
        name=f"prefix_adder[width={width},batch={batch}]", kernel=kernel,
        lib="prefix_adder", path="segments", grid=grid, block=block,
        smem_bytes=smem, smem_model_bytes=0, launch_args=(batch, width),
        operands={"cols": introspect.Operand((batch, width), "int64")},
        outputs={"out": introspect.Operand((batch, width), "int32")},
        meta={"walk": "segments", "seg": seg,
              "ops": batch * introspect.ops_per_row("prefix_adder",
                                                     width, 0),
              "ops_kind": "int32"})


def fast_final_adder(cols: torch.Tensor, use_kernel: bool = True
                     ) -> torch.Tensor:
    """Final adder of (B, W) carry-save columns in log depth.

    ``use_kernel=False`` asks for the plain version on any device.
    """
    if not use_kernel:
        return prefix_final_adder_ref(cols)
    return prefix_final_adder(cols)
