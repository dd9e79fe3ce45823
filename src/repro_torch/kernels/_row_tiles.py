"""Which path of ``csrc/row_tiles.cuh`` moves a limb kernel's rows.

``bank_fold`` (``csrc/bank_fold.cu``), FB and FF (``csrc/mcim_fold.cu``)
and the spatial Karatsuba (``csrc/karatsuba_ppm.cu``, whose bulk kernel
takes rows of 2 limbs only) each have two paths:

* ``"bulk"``: a persistent grid walks tiles of rows; 1-D TMA bulk
  copies bring each tile's A and B spans into a ring of shared buffers,
  and one bulk store writes its products (at 2 limbs each thread stores
  its 16-byte product itself).  A bulk copy takes 16-byte-aligned
  addresses and sizes in multiples of 16 bytes, so the path needs
  16-byte-aligned operands, ``LA = LB`` in 2, 4, 8, 16 limbs, and
  ``rows * LA`` a multiple of 4 (then every tile's spans, the ragged
  last one included, are whole 16-byte units: a tile's rows are a
  multiple of 128).  Its tiles, stages and blocks an SM are
  compile-time constants of the width (``tiles::Bulk``).
* ``"per_thread"``: one block a tile of 128 rows, a thread loading its
  row straight from device memory; products wider than 16 bytes leave
  through shared memory with neighbouring threads on neighbouring
  words.  Any widths, any alignment.

:func:`plan` picks the path from the shape and alignment alone, and
:func:`tile_walk` mirrors the kernels' tile arithmetic, so both are
held here on the CPU.
"""
from __future__ import annotations

PATHS = ("bulk", "per_thread")
#: operand widths (limbs, LA = LB) the bulk kernels are compiled for
BULK_LIMBS = (2, 4, 8, 16)


def plan(rows: int, la: int, lb: int, aligned: bool) -> str:
    """The path of one launch over instances of ``rows`` rows of (LA, LB)
    limbs.  ``aligned``: every operand's base address is a multiple of
    16 bytes."""
    if la == lb and la in BULK_LIMBS and aligned and rows * la % 4 == 0:
        return "bulk"
    return "per_thread"


def tile_walk(n_inst: int, rows: int, tile_rows: int, grid: int) -> list:
    """For each of ``grid`` blocks, its tiles as (instance, first row,
    rows) in the order the bulk kernel walks them: block ``x`` takes
    tiles x, x + grid, ...; tile t is tile t % per_inst of instance
    t // per_inst.  The per-thread path is the walk with one tile a
    block."""
    per_inst = -(-rows // tile_rows)
    total = n_inst * per_inst
    walk = []
    for block in range(grid):
        mine = []
        for t in range(block, total, grid):
            row0 = t % per_inst * tile_rows
            mine.append((t // per_inst, row0, min(tile_rows, rows - row0)))
        walk.append(mine)
    return walk


def is_aligned(*tensors) -> bool:
    """Every tensor's first element at a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
