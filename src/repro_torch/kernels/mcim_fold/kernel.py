"""Folded big-integer multiply: the CUDA kernels and their plain versions.

Counterpart of the reference's ``kernels/mcim_fold/kernel.py``, whose
three TPU kernel bodies (``_fb_kernel``, ``_ff_kernel`` and
``_kara_kernel``) are hand-written CUDA in ``csrc/mcim_fold.cu`` here.
:func:`mcim_fold_mul` launches the kernel for a CUDA tensor and runs the
plain PyTorch version (:func:`mcim_fold_mul_ref`, the core folded
multipliers) for a CPU tensor; nothing else selects between them.  FB
and FF compute the exact product, so they share one kernel with two
paths (TMA bulk copies of row tiles on a persistent grid, and a
coalesced per-thread path); :func:`fold_launch_plan` picks one from the
shape and alignment alone, and their launches count apart.  The folded
Karatsuba is the exact product too: its kernel runs the spatial
Karatsuba's row arithmetic (``csrc/kara_rows.cuh``) on rows zero-padded
to an even N = max(LA, LB), on the per-thread path alone, one launch a
call counted under ``mcim_fold_karatsuba``.  The launches are the custom
ops ``repro_torch::mcim_fold_kernel`` and
``repro_torch::mcim_fold_karatsuba_kernel``, whose fake versions give
the product's shape from the operands' alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import limbs as L
from repro_torch.core.karatsuba import karatsuba_mul
from repro_torch.core.schoolbook import feedback_mul, feedforward_mul, \
    star_mul
from repro_torch.kernels import _build, _row_tiles
from repro_torch.kernels._row_tiles import PATHS

SCHEDULES = ("fb", "ff", "karatsuba")


@dataclasses.dataclass(frozen=True)
class FoldGeometry:
    """Static shape contract of one folded schedule (as in the reference)."""
    schedule: str       # fb | ff | karatsuba
    la: int             # A limbs
    lb: int             # B limbs
    chunk: int          # B limbs consumed per cycle
    ct_run: int         # cycles actually folded (<= requested CT)
    scratch_width: int  # accumulator columns of the reference kernel
    out_width: int      # retired product limbs

    @property
    def b_windows(self) -> tuple:
        """Per-cycle (lo, hi) B-limb windows the PPM consumes (fb/ff)."""
        return tuple((t * self.chunk, (t + 1) * self.chunk)
                     for t in range(self.ct_run))


def fold_geometry(la: int, lb: int, ct: int,
                  schedule: str = "fb") -> FoldGeometry:
    """Static geometry of a folded schedule for (LA, LB) limb operands."""
    if schedule == "karatsuba":
        if ct != 3:
            raise ValueError("the folded Karatsuba schedule is fixed to CT=3")
        n = max(la, lb)
        n += n % 2                               # even split point
        return FoldGeometry(schedule=schedule, la=la, lb=lb,
                            chunk=n // 2 + 1, ct_run=3,
                            scratch_width=2 * n, out_width=la + lb)
    if schedule not in ("fb", "ff"):
        raise ValueError(f"schedule must be fb, ff or karatsuba, "
                         f"got {schedule!r}")
    chunk = -(-lb // ct)
    # CT > LB leaves trailing all-zero chunks: fold only the LB real limbs
    ct_run = -(-lb // chunk)
    if schedule == "fb":
        scratch = la + chunk + 1                 # M + N/CT folded window
    else:
        scratch = la + ct_run * chunk + 1        # full FF register file
    return FoldGeometry(schedule=schedule, la=la, lb=lb, chunk=chunk,
                        ct_run=ct_run, scratch_width=scratch,
                        out_width=la + lb)


def _check_schedule(ct: int, schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be fb, ff or karatsuba, got {schedule!r}")
    if schedule == "karatsuba" and ct != 3:
        raise ValueError("the folded Karatsuba schedule is fixed to CT=3")
    if schedule == "ff" and ct < 2:
        raise ValueError("FF is a multi-cycle design: ct >= 2")


def mcim_fold_mul_ref(a: torch.Tensor, b: torch.Tensor, *, ct: int = 2,
                      schedule: str = "fb") -> torch.Tensor:
    """Plain version: (B, LA) x (B, LB) -> (B, LA+LB) int32 limbs through
    the core folded multipliers (FB at CT=1 is the Star multiplier)."""
    _check_schedule(ct, schedule)
    if schedule == "fb":
        return star_mul(a, b) if ct == 1 else feedback_mul(a, b, ct=ct)
    if schedule == "ff":
        return feedforward_mul(a, b, ct=ct)
    # the kernel realizes one folded Karatsuba level over CT=3 with
    # schoolbook sub-PPMs, i.e. the paper's Karat-1 design
    return karatsuba_mul(a, b, levels=1, ct=ct)


def fold_launch_plan(bsz: int, la: int, lb: int, aligned: bool) -> str:
    """The path of FB's and FF's kernel in ``csrc/mcim_fold.cu`` (one of
    :data:`PATHS`) that takes a (B, LA) x (B, LB) product: ``"bulk"``
    where TMA bulk copies can move every tile (LA = LB in 2, 4, 8, 16, 24;
    16-byte-aligned operands, ``aligned``; B * LA a multiple of 4), else
    ``"per_thread"``: star's odd row count of 2-limb rows, for one.  See
    :mod:`repro_torch.kernels._row_tiles`."""
    return _row_tiles.plan(bsz, la, lb, aligned)


def _checked(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Validate CUDA operands: (B, LA) x (B, LB) int32 limbs."""
    _build.check_cuda_operands(name, a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: expected (B, LA) x (B, LB), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    _build.check_limbs(name, a.shape[1], b.shape[1])


def mcim_fold_mul(a: torch.Tensor, b: torch.Tensor, *, ct: int = 2,
                  schedule: str = "fb") -> torch.Tensor:
    """Batched folded multiply: (B, LA) x (B, LB) -> (B, LA+LB) limbs.

    ``schedule`` picks the paper architecture: "fb" (feedback loop; Star
    at CT=1), "ff" (feed-forward register file) or "karatsuba" (shared
    half-width PPM over the fixed CT=3 fold).  A CUDA tensor launches the
    hand-written kernel; a CPU tensor runs :func:`mcim_fold_mul_ref`.
    """
    _check_schedule(ct, schedule)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mcim_fold_mul_ref(a, b, ct=ct, schedule=schedule)
    _checked(f"mcim_fold_{schedule}", a, b)
    if schedule == "karatsuba":
        return mcim_fold_karatsuba_kernel(a, b)
    return mcim_fold_kernel(a, b, schedule=schedule, path="auto")


def _empty_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.empty((a.shape[0], a.shape[1] + b.shape[1]),
                       dtype=L.LIMB_DTYPE, device=a.device)


# One launch of FB's and FF's kernel on the path ``path`` (one of
# :data:`PATHS`, or "auto": :func:`fold_launch_plan`'s choice) on CUDA
# tensors, counted under ``mcim_fold_fb`` or ``mcim_fold_ff`` as
# ``schedule`` says.  Both compute the exact product, so neither the
# cycles nor the chunk reach the kernel.  :func:`mcim_fold_mul` passes
# "auto"; naming a path lets the card compare the paths on one shape.
# The bulk path raises on operands only the per-thread path takes.
@torch.library.custom_op("repro_torch::mcim_fold_kernel", mutates_args=())
def mcim_fold_kernel(a: torch.Tensor, b: torch.Tensor, *, schedule: str,
                     path: str) -> torch.Tensor:
    if schedule not in ("fb", "ff"):
        raise ValueError(f"schedule must be fb or ff, got {schedule!r}")
    name = f"mcim_fold_{schedule}"
    planned = None
    if a.ndim == 2 and b.ndim == 2:
        planned = fold_launch_plan(a.shape[0], a.shape[1], b.shape[1],
                                   _row_tiles.is_aligned(a, b))
    if path == "auto":
        path = planned
    if path not in PATHS:
        raise ValueError(f"{name}: path must be one of {PATHS}, got "
                         f"{path!r}")
    if path == "bulk" and planned != "bulk":
        raise ValueError(f"{name}: {tuple(a.shape)} x {tuple(b.shape)} "
                         f"operands are not bulk copies' spans; the bulk "
                         f"path does not take them")
    _checked(name, a, b)
    out = _empty_product(a, b)
    if out.shape[0] == 0:
        return out
    symbol = "mcim_fold_bulk_launch" if path == "bulk" else "mcim_fold_launch"
    fn = _build.launcher("mcim_fold", symbol, 3, 3)
    _build.launch(name, fn, (a, b, out), (a.shape[0], a.shape[1],
                                          b.shape[1]), path=path,
                  limbs=max(a.shape[1], b.shape[1]))
    return out


# One launch of the folded Karatsuba's kernel on CUDA tensors, counted
# under ``mcim_fold_karatsuba``.
@torch.library.custom_op("repro_torch::mcim_fold_karatsuba_kernel",
                         mutates_args=())
def mcim_fold_karatsuba_kernel(a: torch.Tensor, b: torch.Tensor
                               ) -> torch.Tensor:
    name = "mcim_fold_karatsuba"
    _checked(name, a, b)
    out = _empty_product(a, b)
    if out.shape[0] == 0:
        return out
    fn = _build.launcher("mcim_fold", f"{name}_launch", 3, 3)
    _build.launch(name, fn, (a, b, out), (a.shape[0], a.shape[1],
                                          b.shape[1]),
                  limbs=max(a.shape[1], b.shape[1]))
    return out


@mcim_fold_kernel.register_fake
def _(a, b, *, schedule, path):
    return _empty_product(a, b)


@mcim_fold_karatsuba_kernel.register_fake
def _(a, b):
    return _empty_product(a, b)
