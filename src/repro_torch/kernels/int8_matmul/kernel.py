"""int8 x int8 matmul with scales: the CUDA kernel and its plain version.

Counterpart of the reference's ``kernels/int8_matmul/{kernel,ref}.py``,
whose TPU kernel ``_matmul_kernel`` is hand-written CUDA in
``csrc/int8_matmul.cu`` here.  :func:`int8_matmul` launches it for CUDA
tensors, whatever their shape, and runs :func:`int8_matmul_ref` for CPU
tensors; nothing else selects between them.

Both compute ``cast(float32(acc) * sx[i] * sw[j])`` in that order, with
``acc`` the exact int32 sum, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

OUT_DTYPES = (torch.bfloat16, torch.float32)


def _exact_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 product x @ w, exactly.  The CPU multiplies in int64;
    CUDA has no integer matmul in PyTorch, so the card multiplies in
    float64, exact while |acc| <= 127**2 * K < 2**53."""
    if x.device.type == "cpu":
        return torch.matmul(x.to(torch.int64), w.to(torch.int64)
                            ).to(torch.int32)
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)
                        ).to(torch.int32)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """Plain version: (M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype``."""
    out = (_exact_acc(x, w).to(torch.float32)
           * sx.reshape(-1, 1).to(torch.float32)
           * sw.reshape(1, -1).to(torch.float32))
    return out.to(out_dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, *, block_m: int = 256, block_n: int = 256,
                block_k: int = 256, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype``, row/col scales.

    sx: (M,) per-row (activation) scales; sw: (N,) per-column (weight)
    scales.  ``block_*`` are the reference's TPU tiles, kept for
    signature parity: the K fold is exact, so they change nothing, and
    the CUDA kernel tiles every shape, ragged edges included, itself.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: expected (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be positive, got "
                         f"{(block_m, block_n, block_k)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_matmul: out_dtype must be one of "
                         f"{OUT_DTYPES}, got {out_dtype}")
    m, k = x.shape
    n = w.shape[1]
    if sx.numel() != m or sw.numel() != n:
        raise ValueError(f"int8_matmul: scales {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)} for a ({m}, {n}) product")
    tensors = (x, w, sx, sw)
    if all(t.device.type == "cpu" for t in tensors):
        return int8_matmul_ref(x, w, sx, sw, out_dtype=out_dtype)
    _build.check_cuda_operands("int8_matmul", x, w, dtype=torch.int8)
    sx = sx.reshape(m).to(torch.float32)
    sw = sw.reshape(n).to(torch.float32)
    _build.check_cuda_operands("int8_matmul", sx, sw, dtype=torch.float32)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.launcher("int8_matmul", "int8_matmul_launch", 5, 4)
    _build.launch("int8_matmul", fn, (x, w, sx, sw, out),
                  (m, k, n, int(out_dtype == torch.bfloat16)))
    return out
