"""Which path of ``csrc/row_tiles.cuh`` takes a bank_fold, FB, FF or
spatial Karatsuba launch.

The choice (:func:`repro_torch.kernels.bank_fold.launch_plan`,
:func:`repro_torch.kernels.mcim_fold.fold_launch_plan`,
:func:`repro_torch.kernels.karatsuba_ppm.launch_plan`) and the tile
walk the kernels follow are plain functions of the shape and alignment,
so they are held here on the CPU; ``tests/test_torch_kernels.py`` runs
both paths on the card against the plain versions.  The bulk kernels' tiles, stages and shared bytes are
compile-time constants of the CUDA source (``tiles::Bulk``, whose
``static_assert`` holds each block under the 232,448 bytes of shared
memory an H100 block may use).
"""
import itertools

import pytest
import torch

from repro_torch import telemetry
from repro_torch.kernels import _build
from repro_torch.kernels import _row_tiles as RT
from repro_torch.kernels import bank_fold as TB
from repro_torch.kernels import karatsuba_ppm as TK
from repro_torch.kernels import mcim_fold as TF

TP3P5_W32 = (4, 300_032, 2)            # fused blocks of a B = 2**20 round
TP5OVER6_W128 = (2, 629_248, 8)
STAR_ROWS = 299_593                     # star (FB at CT=1) of tp3p5_w32
FB8_ROWS = 629_146                      # fb(ct=2) of tp5over6_w128
#: rows of a tile on either path: 128 (per-thread; bulk at 8 and 16
#: limbs), 256 (bulk, 4 limbs), 512 (bulk, 2 limbs)
TILE_ROWS = (128, 256, 512)


@pytest.mark.parametrize("n_inst,rows,la,lb,aligned,path", [
    (*TP3P5_W32, 2, True, "bulk"),              # the main path's shapes
    (*TP5OVER6_W128, 8, True, "bulk"),
    (1, 1_048_576, 2, 2, True, "bulk"),         # FF, tbl8_w32_strict
    (*TP3P5_W32, 2, False, "per_thread"),       # misaligned base
    (1, 7, 2, 2, True, "per_thread"),           # odd rows at LA = 2
    (3, 129, 2, 2, True, "per_thread"),
    (1, 3 * 512 + 1, 2, 2, True, "per_thread"),  # ragged tile of 8 B
    (1, 3 * 512 + 2, 2, 2, True, "bulk"),       # ragged tile of 16 B
    (1, STAR_ROWS, 2, 2, True, "per_thread"),   # star: odd rows
    (1, FB8_ROWS, 8, 8, True, "bulk"),          # the 8-limb FB
    (2, 129, 8, 8, True, "bulk"),               # ragged tile of 1 row
    (1, 128, 3, 3, True, "per_thread"),         # LA = 3
    (2, 128, 3, 5, True, "per_thread"),         # mixed widths
    (1, 128, 2, 4, True, "per_thread"),
    (1, 1, 4, 4, True, "bulk"),
    (4, 1, 16, 16, True, "bulk"),
    (4, 300_032, 16, 16, True, "bulk"),
    (1, 8, 1, 1, True, "per_thread"),           # 8- and 16-bit designs
    (1, 8, 17, 17, True, "per_thread"),         # refused by the wrapper
    (64, 128, 2, 2, True, "bulk"),              # many instances
])
def test_launch_plan_by_shape(n_inst, rows, la, lb, aligned, path):
    got = TB.launch_plan(n_inst, rows, la, lb, aligned)
    assert got == path and path in TB.PATHS
    if n_inst == 1:
        assert TF.fold_launch_plan(rows, la, lb, aligned) == got
    if path == "bulk":              # every instance's spans start whole
        assert la == lb and rows * la * 4 % 16 == 0


@pytest.mark.parametrize("la", (1, 2, 3, 4, 5, 8, 13, 16))
def test_bulk_path_takes_every_shape_bulk_copies_can_move(la):
    for lb, rows, n_inst in itertools.product((la, 2, 16), (1, 2, 127, 4096),
                                              (1, 4, 12)):
        for aligned in (True, False):
            can = (aligned and la == lb and la in (2, 4, 8, 16)
                   and rows * la % 4 == 0)
            got = TB.launch_plan(n_inst, rows, la, lb, aligned)
            assert got == ("bulk" if can else "per_thread")
            if n_inst == 1:
                assert TF.fold_launch_plan(rows, la, lb, aligned) == got
                if la == lb and la % 2 == 0:     # bulk at 2 limbs only
                    assert TK.launch_plan(rows, la, aligned) == (
                        got if la == 2 else "per_thread")


@pytest.mark.parametrize("n_inst,rows,la", [
    TP3P5_W32, TP5OVER6_W128, (1, 1_048_576, 2), (1, 1, 2), (4, 7, 2),
    (3, 127, 4), (2, 128, 8), (4, 129, 16), (3, 3 * 128 + 2, 2),
    (1, 3 * 512 + 2, 2), (1, 255, 3), (1, 7, 2), (1, 3 * 512 + 1, 2),
    (1, STAR_ROWS, 2), (1, FB8_ROWS, 8)])
@pytest.mark.parametrize("grid", (1, 7, 132, 2112))
def test_tiles_cover_every_row_once(n_inst, rows, la, grid):
    bulk = TB.launch_plan(n_inst, rows, la, la, True) == "bulk"
    for tile_rows in TILE_ROWS:
        seen = torch.zeros((n_inst, rows), dtype=torch.int32)
        walk = RT.tile_walk(n_inst, rows, tile_rows, grid)
        assert len(walk) == grid
        for mine in walk:
            for inst, row0, n in mine:
                assert 0 < n <= tile_rows and row0 + n <= rows
                seen[inst, row0:row0 + n] += 1
                if bulk:                 # whole 16-byte spans
                    first = inst * rows + row0
                    for words in (la, 2 * la):
                        assert first * words * 4 % 16 == 0
                        assert n * words * 4 % 16 == 0
        assert torch.equal(seen, torch.ones_like(seen))
        # a block's tiles come in order, each inside one instance
        for mine in walk:
            assert mine == sorted(mine)


def _blocks(n_inst, rows, la, lb, offset=0):
    """(N_INST, R, LA) x (N_INST, R, LB) CPU blocks starting ``offset``
    words into their storage, and an all-windows table."""
    a = torch.zeros(n_inst * rows * la + offset, dtype=torch.int32)
    b = torch.zeros(n_inst * rows * lb + offset, dtype=torch.int32)
    a = a[offset:].view(n_inst, rows, la)
    b = b[offset:].view(n_inst, rows, lb)
    table = torch.tensor([[[0, lb]]] * n_inst, dtype=torch.int32)
    return a, b, table


@pytest.mark.parametrize("n_inst,rows,la,lb,offset", [
    (1, 7, 2, 2, 0), (2, 128, 3, 5, 0), (2, 128, 2, 2, 1),
    (1, 3 * 512 + 1, 2, 2, 0), (1, 128, 2, 2, 1), (1, 128, 3, 5, 0),
    (1, 7, 8, 8, 1), (1, 128, 6, 6, 0), (1, 128, 1, 1, 0)])
def test_bulk_path_refuses_what_bulk_copies_cannot_take(n_inst, rows, la,
                                                        lb, offset):
    a, b, table = _blocks(n_inst, rows, la, lb, offset)
    with pytest.raises(ValueError, match="bulk"):
        TB.fused_bank_mul_kernel(a, b, table, path="bulk")
    if n_inst == 1:
        for schedule in ("fb", "ff"):
            with pytest.raises(ValueError, match="bulk"):
                TF.mcim_fold_kernel(a[0], b[0], schedule=schedule,
                                    path="bulk")
        if la == lb and la % 2 == 0:
            with pytest.raises(ValueError, match="bulk"):
                TK.karatsuba_ppm_kernel(a[0], b[0], path="bulk")


def test_kernel_calls_refuse_unknown_paths_and_cpu_tensors():
    a, b, table = _blocks(2, 128, 2, 2)
    with pytest.raises(ValueError, match="path"):
        TB.fused_bank_mul_kernel(a, b, table, path="tma")
    with pytest.raises(ValueError, match="path"):
        TF.mcim_fold_kernel(a[0], b[0], schedule="ff", path="tma")
    for path in TB.PATHS:
        with pytest.raises(ValueError, match="not CUDA"):
            TB.fused_bank_mul_kernel(a, b, table, path=path)
        with pytest.raises(ValueError, match="not CUDA"):
            TF.mcim_fold_kernel(a[0], b[0], schedule="ff", path=path)
    with pytest.raises(ValueError, match="ct"):    # FF folds over CT >= 2
        TF.mcim_fold_mul(a[0], b[0], ct=1, schedule="ff")
    with pytest.raises(ValueError, match="schedule"):
        TF.mcim_fold_kernel(a[0], b[0], schedule="karatsuba", path="bulk")


@pytest.mark.parametrize("kernel", ("fb", "ff", "karatsuba_ppm"))
def test_new_kernel_calls_refuse_unknown_paths_and_cpu_tensors(kernel):
    """FB's, FF's and the spatial Karatsuba's path calls: an unknown
    path, CPU tensors on either path (no plain version behind them), and
    a view the bulk path cannot take."""
    la = 2 if kernel == "karatsuba_ppm" else 4   # widths with a bulk path
    a, b, _ = _blocks(1, 128, la, la)

    def run(x, y, path):
        if kernel == "karatsuba_ppm":
            return TK.karatsuba_ppm_kernel(x, y, path=path)
        return TF.mcim_fold_kernel(x, y, schedule=kernel, path=path)
    with pytest.raises(ValueError, match="path"):
        run(a[0], b[0], path="tma")
    for path in TF.PATHS:
        with pytest.raises(ValueError, match="not CUDA"):
            run(a[0], b[0], path=path)
    with pytest.raises(ValueError, match="bulk"):    # a view 4 B off
        run(a.reshape(-1)[1:1 + 127 * la].view(127, la), b[0, :127],
            path="bulk")


@pytest.mark.parametrize("rows,la,lb,aligned,path", [
    (STAR_ROWS, 2, 2, True, "per_thread"),      # star, odd rows
    (STAR_ROWS + 1, 2, 2, True, "bulk"),
    (FB8_ROWS, 8, 8, True, "bulk"),             # the 8-limb FB
    (FB8_ROWS, 8, 8, False, "per_thread"),      # a view 4 B off
    (8, 1, 1, True, "per_thread"),              # tbl8_w8 / tbl8_w16
    (7, 1, 1, True, "per_thread"),
    (1_000, 4, 4, True, "bulk"),                # tbl8_w64_lowpower
    (1_001, 4, 4, True, "bulk"),                # any rows above 2 limbs
    (1_000, 3, 5, True, "per_thread"),          # mixed widths
    (1_000, 2, 4, True, "per_thread"),
    (1, 16, 16, True, "bulk"),
])
def test_fb_launch_plan_by_shape(rows, la, lb, aligned, path):
    assert TF.fold_launch_plan(rows, la, lb, aligned) == path


@pytest.mark.parametrize("n", (2, 4, 6, 8, 10, 12, 14, 16))
@pytest.mark.parametrize("rows", (1, 7, 1_048_576, 1_048_575))
@pytest.mark.parametrize("aligned", (True, False))
def test_karatsuba_ppm_launch_plan_by_shape(n, rows, aligned):
    """Rows of 2 limbs take the bulk path when aligned and even in count;
    every other N (the per-thread path matches or beats the bulk walk
    there), views off 16 bytes and odd counts the per-thread one."""
    bulk = aligned and n == 2 and rows % 2 == 0
    want = "bulk" if bulk else "per_thread"
    assert TK.launch_plan(rows, n, aligned) == want


def test_path_counts_reset_with_the_launch_counts():
    for counter in ("launch.bank_fold", "launch.bank_fold.bulk",
                    "launch.mcim_fold_fb.per_thread",
                    "launch.karatsuba_ppm.bulk"):
        telemetry.count(counter)
    assert _build.path_counts()["bank_fold"]["bulk"] >= 1
    assert _build.launch_counts()["bank_fold"] >= 1
    _build.reset_launch_counts()
    assert _build.path_counts() == {
        k: {p: 0 for p in RT.PATHS}
        for k in ("bank_fold", "mcim_fold_fb", "mcim_fold_ff",
                  "karatsuba_ppm")}
    assert set(_build.launch_counts().values()) == {0}
