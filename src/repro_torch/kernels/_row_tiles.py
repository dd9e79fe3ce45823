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
#: rows of a per-thread tile, one thread a row (``tiles::kTileRows``)
TILE_ROWS = 128
#: SMs of the H100 the launch contracts declare their grids for
H100_SMS = 132
#: blocks of each bulk kernel an H100 SM holds at its threads, registers
#: and shared memory (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
#: the card holds the declaration to it, ``python -m repro_torch.verify
#: --device cuda``): 8 at 2 limbs (256 threads), 4 at 4 (49,184 B of
#: shared memory), capped at ``kPerSm`` = 2 from 8 limbs up
H100_BULK_FIT = {"bank_fold": {2: 8, 4: 4, 8: 2, 16: 2},
                 "mcim_fold": {2: 8, 4: 4, 8: 2, 16: 2},
                 "karatsuba_ppm": {2: 8}}


def plan(rows: int, la: int, lb: int, aligned: bool) -> str:
    """The path of one launch over instances of ``rows`` rows of (LA, LB)
    limbs.  ``aligned``: every operand's base address is a multiple of
    16 bytes."""
    if la == lb and la in BULK_LIMBS and aligned and rows * la % 4 == 0:
        return "bulk"
    return "per_thread"


def pitch(words: int) -> int:
    """Words a staged output row takes in shared memory: odd, so that a
    warp writing one column of 32 rows hits 32 distinct banks."""
    return words | 1


def bulk_constants(limbs: int) -> dict:
    """``tiles::Bulk<L>`` of ``csrc/row_tiles.cuh``: threads, rows a
    tile, stages and output slots, blocks an SM at most (0: as many as
    fit) and the dynamic shared bytes of a block (the ring of A + B
    tiles, the output slots and one mbarrier a stage)."""
    if limbs not in BULK_LIMBS:
        raise ValueError(f"no bulk kernel at {limbs} limbs")
    threads = 256 if limbs <= 4 else 128
    tile_rows = (2 if limbs == 2 else 1) * threads
    stages = 4 if limbs == 4 else 2
    slots = 0 if limbs == 2 else 2
    return {"threads": threads, "tile_rows": tile_rows, "stages": stages,
            "slots": slots, "per_sm": 2 if limbs >= 8 else 0,
            "bytes": (stages + slots) * tile_rows * 2 * limbs * 4
            + 8 * stages}


def bulk_launch(lib: str, n_inst: int, rows: int, limbs: int) -> tuple:
    """(grid, threads, dynamic shared bytes) of a bulk launch over
    ``n_inst`` instances of ``rows`` rows on the H100: the persistent
    grid min(tiles, SMs x blocks an SM), as ``tiles::bulk_launch_shape``
    computes it.  ``lib``: the source whose bulk kernel it is."""
    c = bulk_constants(limbs)
    fit = H100_BULK_FIT[lib][limbs]
    per_sm = min(c["per_sm"], fit) if c["per_sm"] else fit
    tiles = n_inst * -(-rows // c["tile_rows"])
    return (min(tiles, H100_SMS * per_sm), 1), c["threads"], c["bytes"]


def tile_launch(maxl: int, n_inst: int, rows: int, la: int, lb: int
                ) -> tuple:
    """(grid, threads, dynamic shared bytes) of a per-thread launch of a
    kernel compiled for ``maxl`` limbs, as ``tiles::tile_launch_shape``
    computes it: a block a tile of :data:`TILE_ROWS` rows of an instance;
    products of more than 4 words staged at :func:`pitch` words a row."""
    smem = 0 if maxl == 2 else TILE_ROWS * pitch(la + lb) * 4
    return (-(-rows // TILE_ROWS), n_inst), TILE_ROWS, smem


def bucket(la: int, lb: int) -> int:
    """The compiled width (``limbs::bucket``) that holds max(LA, LB)."""
    n = max(la, lb)
    return 2 if n <= 2 else 4 if n <= 4 else 8 if n <= 8 else 16


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
