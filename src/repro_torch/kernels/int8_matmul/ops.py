"""Public quantize / matmul / dequantize ops built on the int8 kernel."""
from __future__ import annotations

import torch

from .kernel import int8_matmul, int8_matmul_ref


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization along ``axis``: (q, scale).

    Plain PyTorch, as in the reference (no kernel there either);
    ``torch.round`` rounds half to even like ``jnp.round``.  The scale
    divides by a tensor on ``x``'s device: CUDA divides by a CPU scalar
    as a multiply by its reciprocal, which can round otherwise.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / amax.new_tensor(127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     use_kernel: bool = True, block: int = 128
                     ) -> torch.Tensor:
    """bf16/f32 (M, K) @ (K, N) through int8 with per-row/col scales.

    Every shape goes to :func:`int8_matmul` (the CUDA kernel on the
    card); ``use_kernel=False`` asks for the plain version on any device.
    """
    qx, sx = quantize_rows(x, axis=1)          # per-row of x
    qw, sw = quantize_rows(w, axis=0)          # per-col of w
    if not use_kernel:
        return int8_matmul_ref(qx, qw, sx, sw)
    return int8_matmul(qx, qw, sx, sw, block_m=block, block_n=block,
                       block_k=block)
