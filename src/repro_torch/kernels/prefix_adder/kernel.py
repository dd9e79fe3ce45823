"""Parallel-prefix final adder: the CUDA kernel and its plain version.

Counterpart of the reference's ``kernels/prefix_adder/{kernel,ref}.py``,
whose TPU kernel ``_adder_kernel`` is hand-written CUDA in
``csrc/prefix_adder.cu`` here.  :func:`prefix_final_adder` launches it
for a CUDA tensor and runs :func:`prefix_final_adder_ref`, the core
library's sequential 1CA, for a CPU tensor; nothing else selects between
them.  The launch is the custom op ``repro_torch::prefix_adder_kernel``,
whose fake version gives the limbs' shape from the columns' alone.

Columns are the port's carry-save dtype, ``torch.int64``, holding the
reference's uint32 column values.  Both versions are exact mod
2**(16W) for columns below 2**32 - 2**16 (all MCIM producers stay
there: the reference's ``verify.intervals``).
"""
from __future__ import annotations

import torch

from repro_torch.core import limbs as L
from repro_torch.kernels import _build

#: widest row the kernel takes: two columns per lane of a warp
MAX_WIDTH = 64


def prefix_final_adder_ref(cols: torch.Tensor) -> torch.Tensor:
    """Plain version: the sequential 1CA, (B, W) -> (B, W) int32 limbs."""
    return L.final_adder_1ca(cols)


def prefix_final_adder(cols: torch.Tensor, *, tile_b: int = 256
                       ) -> torch.Tensor:
    """(B, W) carry-save columns -> (B, W) canonical limbs (mod 2**16W).

    ``tile_b`` is the reference's TPU batch tile, kept for signature
    parity; it changes neither the result nor the CUDA launch.
    """
    if tile_b < 1:
        raise ValueError(f"tile_b must be positive, got {tile_b}")
    if cols.device.type == "cpu":
        return prefix_final_adder_ref(cols)
    return prefix_adder_kernel(cols)


# One launch of the prefix adder on (B, W) int64 CUDA columns.
@torch.library.custom_op("repro_torch::prefix_adder_kernel",
                         mutates_args=())
def prefix_adder_kernel(cols: torch.Tensor) -> torch.Tensor:
    _build.check_cuda_operands("prefix_adder", cols, dtype=L.COL_DTYPE)
    if cols.ndim != 2:
        raise ValueError(f"prefix_adder: expected (B, W) columns, got "
                         f"{tuple(cols.shape)}")
    bsz, width = cols.shape
    if width > MAX_WIDTH:
        raise ValueError(f"prefix_adder: {width} columns exceed the "
                         f"kernel's {MAX_WIDTH}")
    out = torch.empty((bsz, width), dtype=L.LIMB_DTYPE, device=cols.device)
    if out.numel() == 0:
        return out
    fn = _build.launcher("prefix_adder", "prefix_adder_launch", 2, 2)
    _build.launch("prefix_adder", fn, (cols, out), (bsz, width))
    return out


@prefix_adder_kernel.register_fake
def _(cols):
    return cols.new_empty(cols.shape, dtype=L.LIMB_DTYPE)
