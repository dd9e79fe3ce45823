"""Spatial one-level Karatsuba multiply: the CUDA kernel and its plain
version.

Counterpart of the reference's ``kernels/karatsuba_ppm/{kernel,ref}.py``,
whose TPU kernel ``_kara_kernel`` is hand-written CUDA in
``csrc/karatsuba_ppm.cu`` here, with the two paths of
``csrc/row_tiles.cuh``: TMA bulk copies of row tiles on a persistent
grid for rows of 2 limbs (16-byte-aligned operands, an even row count),
and a coalesced per-thread path for every other N, misaligned views and
odd row counts (at N = 4, 8 and 16 it matches or beats the bulk walk on
the H100, ``PERF.md`` section 6).
:func:`launch_plan` picks the path from the shape and alignment alone;
:func:`karatsuba_ppm_mul` launches it for CUDA tensors and runs
:func:`karatsuba_ppm_mul_ref`, the core library's one-level Karatsuba
multiplier, for CPU tensors; nothing else selects between them.  The
launch is the custom op ``repro_torch::karatsuba_ppm_kernel``, whose
fake version gives the product's shape from the operands' alone.
"""
from __future__ import annotations

import torch

from repro_torch.core import limbs as L
from repro_torch.core.karatsuba import karatsuba_mul
from repro_torch.kernels import _build, _row_tiles
from repro_torch.kernels._row_tiles import PATHS


def karatsuba_ppm_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, N) x (B, N) -> (B, 2N) int32 limbs."""
    return karatsuba_mul(a, b, levels=1, ct=3)


#: the widths (limbs) at which the bulk kernel is built and taken
BULK_N = (2,)


def launch_plan(bsz: int, n: int, aligned: bool) -> str:
    """The path of ``csrc/karatsuba_ppm.cu`` (one of :data:`PATHS`) that
    takes a (B, N) x (B, N) product: ``"bulk"`` for N in :data:`BULK_N`
    where TMA bulk copies can move every tile (16-byte-aligned operands,
    ``aligned``; B * N a multiple of 4), else ``"per_thread"``.  See
    :mod:`repro_torch.kernels._row_tiles`."""
    if n not in BULK_N:
        return "per_thread"
    return _row_tiles.plan(bsz, n, n, aligned)


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"karatsuba_ppm: expected (B, N) x (B, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.shape[1] % 2:
        raise ValueError(f"karatsuba_ppm: even limb count required (pad "
                         f"first), got {a.shape[1]}")


def karatsuba_ppm_mul(a: torch.Tensor, b: torch.Tensor, *,
                      tile_b: int = 256) -> torch.Tensor:
    """Batched one-level Karatsuba multiply: (B, N) x (B, N) -> (B, 2N).

    N must be even, as in the reference (pad first).  ``tile_b`` is the
    reference's TPU batch tile, kept for signature parity; it changes
    neither the result nor the CUDA launch.
    """
    _check_shapes(a, b)
    if tile_b < 1:
        raise ValueError(f"tile_b must be positive, got {tile_b}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return karatsuba_ppm_mul_ref(a, b)
    return karatsuba_ppm_kernel(a, b, path="auto")


# One launch of the path ``path`` (one of :data:`PATHS`, or "auto":
# :func:`launch_plan`'s choice) on CUDA tensors.  :func:`karatsuba_ppm_mul`
# passes "auto"; naming a path lets the card compare the paths on one
# shape.  The bulk path raises on operands only the per-thread path takes.
@torch.library.custom_op("repro_torch::karatsuba_ppm_kernel",
                         mutates_args=())
def karatsuba_ppm_kernel(a: torch.Tensor, b: torch.Tensor, *,
                         path: str) -> torch.Tensor:
    _check_shapes(a, b)
    bsz, n = a.shape
    planned = launch_plan(bsz, n, _row_tiles.is_aligned(a, b))
    if path == "auto":
        path = planned
    if path not in PATHS:
        raise ValueError(f"karatsuba_ppm: path must be one of {PATHS}, "
                         f"got {path!r}")
    if path == "bulk" and planned != "bulk":
        raise ValueError(f"karatsuba_ppm: the bulk path does not take "
                         f"{tuple(a.shape)} operands (rows of {BULK_N} "
                         f"limbs, 16-byte aligned, B * N a multiple of 4)")
    _build.check_cuda_operands("karatsuba_ppm", a, b)
    _build.check_limbs("karatsuba_ppm", n, n)
    out = torch.empty((bsz, 2 * n), dtype=L.LIMB_DTYPE, device=a.device)
    if out.numel() == 0:
        return out
    symbol = ("karatsuba_ppm_bulk_launch" if path == "bulk"
              else "karatsuba_ppm_launch")
    fn = _build.launcher("karatsuba_ppm", symbol, 3, 2)
    _build.launch("karatsuba_ppm", fn, (a, b, out), (bsz, n), path=path,
                  limbs=n)
    return out


@karatsuba_ppm_kernel.register_fake
def _(a, b, *, path):
    _check_shapes(a, b)
    return a.new_empty((a.shape[0], 2 * a.shape[1]), dtype=L.LIMB_DTYPE)
