"""int8 x int8 matmul with scales: the CUDA kernels and their plain version.

Counterpart of the reference's ``kernels/int8_matmul/{kernel,ref}.py``,
whose TPU kernel ``_matmul_kernel`` is hand-written CUDA in
``csrc/int8_matmul.cu`` here, as two kernels: a ``wgmma`` kernel fed by
TMA for the shapes TMA can load, and an ``mma.sync`` kernel for the
rest.  :func:`kernel_path` picks one from the shape and alignment alone;
:func:`int8_matmul` launches it for CUDA tensors, whatever their shape,
and runs :func:`int8_matmul_ref` for CPU tensors; nothing else selects
between them.  The launch is the custom op
``repro_torch::int8_matmul_kernel``, whose fake version gives the
output's shape and dtype from the operands' shapes alone.

All compute ``cast(float32(acc) * sx[i] * sw[j])`` in that order, with
``acc`` the exact int32 sum, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _row_tiles

OUT_DTYPES = (torch.bfloat16, torch.float32)
#: the kernels of ``csrc/int8_matmul.cu``, in the order of its ``path``
PATHS = ("mma_sync", "wgmma_decode", "wgmma_prefill")
#: x rows of a wgmma decode tile (64 x 64; the prefill tiles are 128 x 256)
DECODE_ROWS = 64


def kernel_path(m: int, k: int, n: int, aligned: bool = True) -> str:
    """The kernel of ``csrc/int8_matmul.cu`` that takes an (M, K) @ (K, N)
    product, one of :data:`PATHS`.

    The wgmma kernel loads x and w by TMA, which wants row strides (K and
    N bytes) and base addresses (``aligned``) in multiples of 16 bytes;
    every other shape, and K = 0, goes to the mma.sync kernel.  Of the
    wgmma tiles, the decode ones (64 x rows, 64 w columns) are taken
    where one row tile covers x, M <= 64: w is streamed once, by twice
    as many blocks as the card has SMs.  Above that they would re-read w
    once per 64 rows and x once per 64 columns, and the prefill tiles
    (128 x 256) are faster from M = 128 up at gemma2-9b's K, N
    (``chip_smoke.py`` phase 2 sweeps M over both).
    """
    if k == 0 or k % 16 or n % 16 or not aligned:
        return "mma_sync"
    return "wgmma_decode" if m <= DECODE_ROWS else "wgmma_prefill"


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


def _checked(x, w, sx, sw, out_dtype) -> None:
    """Validate the operands of an (M, K) @ (K, N) product."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: expected (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_matmul: out_dtype must be one of "
                         f"{OUT_DTYPES}, got {out_dtype}")
    if sx.numel() != x.shape[0] or sw.numel() != w.shape[1]:
        raise ValueError(f"int8_matmul: scales {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)} for a ({x.shape[0]}, "
                         f"{w.shape[1]}) product")


def int8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, *, block_m: int = 256, block_n: int = 256,
                block_k: int = 256, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) ``out_dtype``, row/col scales.

    sx: (M,) per-row (activation) scales; sw: (N,) per-column (weight)
    scales.  ``block_*`` are the reference's TPU tiles, kept for
    signature parity: the K fold is exact, so they change nothing, and
    the CUDA kernels tile every shape, ragged edges included, themselves.
    """
    _checked(x, w, sx, sw, out_dtype)
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be positive, got "
                         f"{(block_m, block_n, block_k)}")
    if all(t.device.type == "cpu" for t in (x, w, sx, sw)):
        return int8_matmul_ref(x, w, sx, sw, out_dtype=out_dtype)
    return int8_matmul_kernel(x, w, sx, sw, path="auto",
                              out_dtype=out_dtype)


# One launch of the kernel ``path`` (one of :data:`PATHS`, or "auto":
# :func:`kernel_path`'s choice) on CUDA tensors.  :func:`int8_matmul`
# passes "auto"; naming a kernel lets the card compare the kernels on
# one shape.  A wgmma path raises on a shape that only mma.sync takes.
@torch.library.custom_op("repro_torch::int8_matmul_kernel", mutates_args=())
def int8_matmul_kernel(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                       sw: torch.Tensor, *, path: str,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    _checked(x, w, sx, sw, out_dtype)
    m, k = x.shape
    n = w.shape[1]
    planned = kernel_path(m, k, n, _row_tiles.is_aligned(x, w))
    if path == "auto":
        path = planned
    if path not in PATHS:
        raise ValueError(f"int8_matmul: path must be one of {PATHS}, "
                         f"got {path!r}")
    if path != "mma_sync" and planned == "mma_sync":
        raise ValueError(f"int8_matmul: ({m}, {k}) @ ({k}, {n}) is not a "
                         f"shape TMA loads; {path} does not take it")
    _build.check_cuda_operands("int8_matmul", x, w, dtype=torch.int8)
    sx = sx.reshape(m).to(torch.float32)
    sw = sw.reshape(n).to(torch.float32)
    _build.check_cuda_operands("int8_matmul", sx, sw, dtype=torch.float32)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.launcher("int8_matmul", "int8_matmul_launch", 5, 5)
    _build.launch("int8_matmul", fn, (x, w, sx, sw, out),
                  (m, k, n, int(out_dtype == torch.bfloat16),
                   PATHS.index(path)))
    return out


@int8_matmul_kernel.register_fake
def _(x, w, sx, sw, *, path, out_dtype=torch.bfloat16):
    _checked(x, w, sx, sw, out_dtype)
    return x.new_empty((x.shape[0], w.shape[1]), dtype=out_dtype)
