"""Spatial one-level Karatsuba multiply: the CUDA kernel and its plain
version.

Counterpart of the reference's ``kernels/karatsuba_ppm/{kernel,ref}.py``,
whose TPU kernel ``_kara_kernel`` is hand-written CUDA in
``csrc/karatsuba_ppm.cu`` here.  :func:`karatsuba_ppm_mul` launches it
for CUDA tensors and runs :func:`karatsuba_ppm_mul_ref`, the core
library's one-level Karatsuba multiplier, for CPU tensors; nothing else
selects between them.
"""
from __future__ import annotations

import torch

from repro_torch.core import limbs as L
from repro_torch.core.karatsuba import karatsuba_mul
from repro_torch.kernels import _build


def karatsuba_ppm_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, N) x (B, N) -> (B, 2N) int32 limbs."""
    return karatsuba_mul(a, b, levels=1, ct=3)


def karatsuba_ppm_mul(a: torch.Tensor, b: torch.Tensor, *,
                      tile_b: int = 256) -> torch.Tensor:
    """Batched one-level Karatsuba multiply: (B, N) x (B, N) -> (B, 2N).

    N must be even, as in the reference (pad first).  ``tile_b`` is the
    reference's TPU batch tile, kept for signature parity; it changes
    neither the result nor the CUDA launch.
    """
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"karatsuba_ppm: expected (B, N) x (B, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    bsz, n = a.shape
    if n % 2:
        raise ValueError(f"karatsuba_ppm: even limb count required (pad "
                         f"first), got {n}")
    if tile_b < 1:
        raise ValueError(f"tile_b must be positive, got {tile_b}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return karatsuba_ppm_mul_ref(a, b)
    _build.check_cuda_operands("karatsuba_ppm", a, b)
    _build.check_limbs("karatsuba_ppm", n, n)
    out = torch.empty((bsz, 2 * n), dtype=L.LIMB_DTYPE, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.launcher("karatsuba_ppm", "karatsuba_ppm_launch", 3, 2)
    _build.launch("karatsuba_ppm", fn, (a, b, out), (bsz, n))
    return out
