"""Public wrappers for the folded big-int multiply kernels."""
from __future__ import annotations

import torch

from .kernel import fold_geometry, fold_launch_plan, mcim_fold_mul

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


def launch_contract(la: int, lb: int, ct: int, schedule: str = "fb",
                    batch: int = 256):
    """Static :class:`~repro_torch.kernels.introspect.LaunchContract`.

    Declares the launch :func:`big_mul` issues for a ``batch`` of (LA,
    LB) multiplications (unpadded: the kernels mask the row edge): FB
    and FF on the path :func:`.kernel.fold_launch_plan` takes for
    aligned operands, the folded Karatsuba (``ct`` is 3) on its
    per-thread kernel of N = max(LA, LB) rounded up to even limbs.
    """
    from repro_torch.kernels import introspect
    run_ct = 3 if schedule == "karatsuba" else ct
    geo = fold_geometry(la, lb, run_ct, schedule)
    if schedule == "karatsuba":
        n = geo.scratch_width // 2
        path, kernel = "per_thread", "mcim_fold_karatsuba_launch"
        ops = introspect.kara_row_ops(n)
    else:
        path = fold_launch_plan(batch, la, lb, True)
        kernel = ("mcim_fold_bulk_launch" if path == "bulk"
                  else "mcim_fold_launch")
        ops = introspect.ops_per_row(f"mcim_fold_{schedule}", la, lb,
                                     ct_run=geo.ct_run, chunk=geo.chunk)
    return introspect.row_tile_contract(
        name=(f"mcim_fold/{schedule}[la={la},lb={lb},ct={run_ct},"
              f"batch={batch}]"),
        lib="mcim_fold", kernel=kernel, path=path, n_inst=1, rows=batch,
        la=la, lb=lb, launch_args=(batch, la, lb),
        operands={"a": introspect.Operand((batch, la), "int32"),
                  "b": introspect.Operand((batch, lb), "int32")},
        out_shape=(batch, la + lb), ops=batch * ops)


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
