"""Public wrappers for the folded big-int multiply kernels."""
from __future__ import annotations

import torch

from .kernel import fold_geometry, mcim_fold_mul

_TILES = (512, 256, 128, 64, 32, 16, 8)


def batch_tile(bsz: int) -> tuple:
    """Pick (tile, pad) for a batch of ``bsz`` multiplications, as the
    reference does: the largest candidate tile dividing the batch, else a
    pad of at most ~12.5% rows up to a candidate multiple, else one exact
    short tile.  The fused bank pads its per-instance row blocks with it
    (:func:`repro_torch.kernels.bank_fold.fused_block_rows`), so its
    blocks have the reference's shapes."""
    for cand in _TILES:
        if bsz % cand == 0:
            return cand, 0
    for cand in _TILES:
        pad = -bsz % cand
        if cand <= 2 * bsz and pad * 8 <= bsz:
            return cand, pad
    return bsz, 0


def big_mul(a: torch.Tensor, b: torch.Tensor, ct: int = 2,
            schedule: str = "fb") -> torch.Tensor:
    """Batched wide-int multiply; a 1-D operand pair is one row.  The CUDA
    kernels mask the ragged row edge themselves, so nothing is padded."""
    if a.ndim == 1:
        return big_mul(a[None], b[None], ct=ct, schedule=schedule)[0]
    return mcim_fold_mul(a, b, ct=ct, schedule=schedule)


def vmem_bytes_per_step(la: int, lb: int, ct: int, tile_b: int,
                        schedule: str = "fb") -> int:
    """The reference's per-step working-set figure, the area-model
    quantity ``BankReport.working_set_bytes`` reports.

    It models the paper's folded silicon (A tile + B chunk + accumulator
    words of a ``tile_b``-row tile); it is not a memory size of the TPU
    or of the H100 kernels.
    """
    geo = fold_geometry(la, lb, 3 if schedule == "karatsuba" else ct,
                        schedule)
    if schedule == "karatsuba":
        hp = geo.chunk                  # half-width PPM port (n/2 + 1)
        words = tile_b * (2 * hp        # this cycle's operand port pair
                          + 2 * hp      # shared PPM window (T_j columns)
                          + geo.scratch_width)  # compressor feedback acc
        return words * 4
    words = tile_b * (geo.la          # A tile
                      + geo.chunk     # B chunk
                      + geo.scratch_width)  # acc window / register file
    return words * 4
