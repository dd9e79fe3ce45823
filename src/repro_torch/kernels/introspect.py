"""Launch contracts: what each kernel package *declares* about a launch.

Counterpart of the reference's ``kernels/introspect.py``, for CUDA.  The
static dataflow analyzer (:mod:`repro_torch.verify.dataflow`) proves
hazard freedom, bounds, the shared-memory model and a roofline for
every kernel launch a plan implies, without executing anything.  It
must not reverse-engineer grids or shared memory out of the launchers:
the package that launches a kernel owns those facts, so each package
exposes a ``launch_contract(...)`` hook returning a
:class:`LaunchContract`:

  kernel, lib       the launcher symbol of ``csrc/<lib>.cu`` and its
                    ``int`` arguments (``launch_args``); the launcher's
                    ``*_launch_shape`` entry returns the launch it makes
                    for them, which the card holds the contract to
  path              the kernel's path (``"bulk"`` / ``"per_thread"``,
                    or the int8 kernel's ``kernel_path``)
  grid, block       the grid and threads a block the package intends
  smem_bytes        dynamic shared memory at launch
  smem_model_bytes  the package's declared per-block working set; the
                    analyzer checks the launch stays within it
  operands, outputs name -> :class:`Operand` (shape, dtype, bytes)
  table, idle_steps the concrete window table of a fused launch and its
                    masked idle (instance, step) pairs
  meta              what the analyzer needs beyond that: the block walk
                    (``walk``), the integer operations (``ops``), the
                    fused dispatch's owner table and assignment

:meth:`LaunchContract.blocks` gives each block's work, the output rows
it writes and the operand spans it reads, from the kernels' own index
arithmetic: the bulk row-tile walk is :func:`._row_tiles.tile_walk`.

The module also keeps the integer operations a row of each limb kernel
issues, and the bound the H100's figures (:mod:`repro_torch.h100`) set
on a launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np

from repro_torch import h100
from . import _row_tiles
from ._build import MAX_LIMBS

#: operations a second of each kind a launch counts
OPS_PER_S = {"int32": h100.INT32_OPS_PER_S, "int8": h100.INT8_TC_OPS_PER_S}

_ITEMSIZE = {"int8": 1, "int32": 4, "int64": 8, "float32": 4,
             "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand or output of a launch: its shape and element type.
    The analyzer views it as a matrix of ``rows`` x ``cols`` elements
    (a 1-D operand is one row)."""
    shape: tuple
    dtype: str

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self.dtype]

    @property
    def cols(self) -> int:
        return int(self.shape[-1])

    @property
    def rows(self) -> int:
        return int(np.prod(self.shape[:-1], dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.rows * self.cols * self.itemsize


@dataclasses.dataclass(frozen=True)
class BlockWork:
    """What one block of a launch touches: ``reads`` and ``writes`` are
    ``(name, (row0, row1), (col0, col1))`` regions of the operands'
    matrix views, half-open."""
    block: tuple
    reads: tuple
    writes: tuple


@dataclasses.dataclass(frozen=True)
class LaunchContract:
    """One kernel package's static declaration of one CUDA launch."""
    name: str                      # e.g. "mcim_fold/fb[la=2,lb=2,ct=2]"
    kernel: str                    # launcher symbol of csrc/<lib>.cu
    lib: str
    path: str
    grid: tuple                    # (grid.x, grid.y)
    block: int                     # threads a block
    smem_bytes: int                # dynamic shared memory at launch
    smem_model_bytes: int          # declared per-block working set
    launch_args: tuple             # the launcher's int arguments
    operands: Mapping              # name -> Operand
    outputs: Mapping               # name -> Operand
    table: Optional[Any] = None    # np.ndarray window table
    idle_steps: tuple = ()         # masked (instance, step) pairs
    meta: Mapping = dataclasses.field(default_factory=dict)

    def matches_idle(self, step: tuple) -> bool:
        """Whether ``step`` is declared architecturally idle (a ``None``
        in a declared pair matches any value)."""
        return any(all(p is None or p == s for p, s in zip(pat, step))
                   for pat in self.idle_steps)

    @property
    def shape_symbol(self) -> str:
        """The launcher's ``*_launch_shape`` entry."""
        return self.kernel + "_shape"

    @property
    def attributes_symbol(self) -> str:
        """The launcher's ``*_attributes`` entry."""
        return self.kernel[:-len("_launch")] + "_attributes"

    def blocks(self):
        """Each block's :class:`BlockWork`, in block order.  Raises
        ``KeyError`` for a walk this module does not know."""
        return _WALKS[self.meta["walk"]](self)


# --------------------------------------------------------------- walks

def _row_regions(c: LaunchContract, row0: int, n: int) -> tuple:
    """The reads and writes of ``n`` rows from row ``row0``: rows of A, B
    and the product, and where the launch reads an owner table
    (``bank_fold``: rows in batch order), the rows' owners and every
    instance's windows."""
    span = (row0, row0 + n)
    reads = tuple((name, span, (0, c.operands[name].cols))
                  for name in ("a", "b"))
    if "owner" in c.operands:
        reads += (("owner", (0, 1), span),
                  ("table", (0, c.operands["table"].rows), (0, 2)))
    return reads, (("out", span, (0, c.outputs["out"].cols)),)


def _walk_bulk(c: LaunchContract):
    """The bulk walk (``tiles::bulk_walk``): block x takes tiles x,
    x + grid, ... of ``tile_rows`` rows."""
    walk = _row_tiles.tile_walk(c.meta["rows"], c.meta["tile_rows"],
                                c.grid[0])
    for x, tiles in enumerate(walk):
        reads, writes = (), ()
        for row0, n in tiles:
            r, w = _row_regions(c, row0, n)
            reads += r
            writes += w
        yield BlockWork((x, 0), reads, writes)


def _walk_tiles(c: LaunchContract):
    """The per-thread path (``tiles::coalesced_tile``): block x takes
    rows x * threads ..., masked at the row edge."""
    rows = c.meta["rows"]
    for x in range(c.grid[0]):
        row0 = x * c.block
        n = min(c.block, rows - row0)
        if n <= 0:
            yield BlockWork((x, 0), (), ())
            continue
        reads, writes = _row_regions(c, row0, n)
        yield BlockWork((x, 0), reads, writes)


def _walk_segments(c: LaunchContract):
    """The prefix adder: block x's threads x * block ... hold rows of
    ``seg`` lanes each; rows past the batch load and store nothing."""
    bsz, width = c.operands["cols"].shape
    per = c.block // c.meta["seg"]
    for x in range(c.grid[0]):
        r0, r1 = x * per, min(bsz, (x + 1) * per)
        if r0 >= r1:
            yield BlockWork((x, 0), (), ())
            continue
        yield BlockWork((x, 0), (("cols", (r0, r1), (0, width)),),
                        (("out", (r0, r1), (0, width)),))


def _walk_matmul(c: LaunchContract):
    """The int8 kernels: block (x, y) owns output tile x of ``tile[0]``
    rows and y of ``tile[1]`` columns, guarded at the edges; it reads
    its rows of x and sx and its columns of w and sw over all of K."""
    m, k = c.operands["x"].shape
    n = c.operands["w"].shape[1]
    tm, tn = c.meta["tile"]
    for x in range(c.grid[0]):
        for y in range(c.grid[1]):
            rows = (x * tm, min(m, (x + 1) * tm))
            cols = (y * tn, min(n, (y + 1) * tn))
            if rows[0] >= rows[1] or cols[0] >= cols[1]:
                yield BlockWork((x, y), (), ())
                continue
            yield BlockWork((x, y), (
                ("x", rows, (0, k)), ("w", (0, k), cols),
                ("sx", (0, 1), rows), ("sw", (0, 1), cols)),
                (("out", rows, cols),))


_WALKS = {"bulk": _walk_bulk, "tiles": _walk_tiles,
          "segments": _walk_segments, "matmul": _walk_matmul}


# ------------------------------------------------------ row-tile launches

def row_tile_contract(*, name: str, lib: str, kernel: str, path: str,
                      rows: int, la: int, lb: int, launch_args: tuple,
                      operands: dict, out_shape: tuple, ops: int,
                      **extra) -> LaunchContract:
    """The contract of one launch of a row-tile kernel (``bank_fold``,
    FB/FF, both Karatsubas) over ``rows`` rows:
    the grid, threads and shared memory :func:`launch_shape` gives for
    its arguments, and the model ``tiles::Bulk<L>::kBytes`` on the bulk
    path, a tile of staged output rows (``kTileRows x pitch(LA + LB)``
    words) on the per-thread path."""
    grid, block, smem = launch_shape(kernel, launch_args)
    if path == "bulk":
        model = smem
        walk = {"walk": "bulk",
                "tile_rows": _row_tiles.bulk_constants(la)["tile_rows"]}
    else:
        model = _row_tiles.TILE_ROWS * _row_tiles.pitch(la + lb) * 4
        walk = {"walk": "tiles"}
    return LaunchContract(
        name=name, kernel=kernel, lib=lib, path=path, grid=grid,
        block=block, smem_bytes=smem, smem_model_bytes=model,
        launch_args=tuple(int(v) for v in launch_args),
        operands=operands,
        outputs={"out": Operand(tuple(out_shape), "int32")},
        table=extra.pop("table", None),
        idle_steps=extra.pop("idle_steps", ()),
        meta={**walk, "rows": rows, "la": la, "lb": lb,
              "ops": int(ops), "ops_kind": "int32", **extra})


# ------------------------------------------------------ launcher mirrors

#: every launcher of ``csrc/``: its source and the paths its kernels take
LAUNCHERS = {
    "bank_fold_launch": ("bank_fold", ("per_thread",)),
    "bank_fold_bulk_launch": ("bank_fold", ("bulk",)),
    "mcim_fold_launch": ("mcim_fold", ("per_thread",)),
    "mcim_fold_bulk_launch": ("mcim_fold", ("bulk",)),
    "mcim_fold_karatsuba_launch": ("mcim_fold", ("per_thread",)),
    "karatsuba_ppm_launch": ("karatsuba_ppm", ("per_thread",)),
    "karatsuba_ppm_bulk_launch": ("karatsuba_ppm", ("bulk",)),
    "prefix_adder_launch": ("prefix_adder", ("segments",)),
    "int8_matmul_launch": ("int8_matmul",
                           ("mma_sync", "wgmma_decode", "wgmma_prefill")),
}


def launch_shape(kernel: str, args: tuple) -> tuple:
    """(grid, threads, dynamic shared bytes) the launcher ``kernel``
    makes for its int arguments ``args`` on the H100: the Python mirror
    of each ``*_launch_shape`` entry of ``csrc/``.  Raises
    ``ValueError`` where the launcher refuses the arguments and
    ``KeyError`` for a launcher it does not know."""
    rt = _row_tiles
    lib = LAUNCHERS[kernel][0]
    if lib == "prefix_adder":
        bsz, width = args
        seg = min(32, 1 << (width - 1).bit_length())
        return (-(-bsz * seg // 256), 1), 256, 0
    if lib == "int8_matmul":
        from .int8_matmul import PATHS
        from .int8_matmul.ops import TILES
        m, k, n, _, path = args
        path = PATHS[path]
        if path != "mma_sync" and (k <= 0 or k % 16 or n % 16):
            raise ValueError(f"{kernel}: TMA does not load ({m}, {k}) @ "
                             f"({k}, {n})")
        (tm, tn), threads, dynamic, _ = TILES[path]
        return (-(-m // tm), -(-n // tn)), threads, dynamic
    if lib == "bank_fold":         # a round's rows in batch order
        n_bank, rows, la, lb, _ = args
    elif lib == "mcim_fold":
        rows, la, lb = args
    else:
        rows, la = args
        lb = la
        if la % 2 or not 2 <= la <= MAX_LIMBS:
            raise ValueError(f"{kernel}: N = {la} is not an even "
                             f"2-{MAX_LIMBS}")
    if kernel.endswith("_bulk_launch"):
        if la != lb or la not in rt.H100_BULK_FIT[lib] or rows * la % 4:
            raise ValueError(f"{kernel}: the bulk path does not take "
                             f"{rows} rows of {la}x{lb} limbs")
        if lib != "bank_fold":
            return rt.bulk_launch(lib, rows, la)
        if not 1 <= n_bank <= rt.BULK_INSTANCES:
            raise ValueError(f"{kernel}: a bulk block keeps the limb "
                             f"weights of 1 to {rt.BULK_INSTANCES} "
                             f"instances, not {n_bank}")
        return rt.bulk_launch(lib, rows, la, n_bank * la * 4)
    if kernel == "mcim_fold_karatsuba_launch":
        maxl = max(la, lb) + max(la, lb) % 2
    elif lib == "karatsuba_ppm":
        maxl = la
    else:
        maxl = rt.bucket(la, lb)
    return rt.tile_launch(maxl, rows, la, lb)


# ------------------------------------------------------ operation counts

def ops_per_row(kernel: str, la: int, lb: int, windows=None, ct_run=1,
                chunk=1) -> int:
    """Integer operations one row needs: 5 per 16x16 limb product (mul,
    mask, shift, two adds) and 3 per carry-propagated column.  For the
    prefix adder ``la`` is the row's column count; for the spatial
    Karatsuba this is the reference's count (``kara_row_ops`` is what
    the CUDA rows issue)."""
    if kernel == "prefix_adder":
        rounds = (la - 1).bit_length()             # ceil(log2 W)
        # split and fold 4, (g, p, base) 4, 4 a round, carry-in and store 3
        return la * (11 + 4 * rounds)
    if kernel == "karatsuba_ppm":               # the reference's count
        h, hp = la // 2, la // 2 + 1
        return (2 * (h + 3 * hp)                   # A0+A1, B0+B1 and 1CA
                + 5 * (2 * h * h + hp * hp)        # three PPM passes
                + 3 * (4 * h + 2 * hp)             # their carry passes
                + 4 * 2 * la + 1                   # placement, complements
                + 3 * 2 * la)                      # final adder
    if kernel == "bank_fold":
        width = sum(hi - lo for lo, hi in windows)
        return 5 * la * width + 3 * (la + lb)
    if kernel == "mcim_fold_fb":
        return 5 * la * lb + 3 * ct_run * (la + chunk + 1)
    if kernel == "mcim_fold_ff":
        return 5 * la * lb + 3 * (la + lb)
    n = max(la, lb) + max(la, lb) % 2
    h, hp = n // 2, n // 2 + 1
    return (2 * 4 * h                          # A0+A1, B0+B1
            + 3 * (5 * hp * hp + 3 * 2 * hp)   # three PPM passes + 1CA
            + 3 * 2 * hp + 2 * (2 * 2 * n + 1)  # placements, NOT+1 terms
            + 3 * (la + lb))                   # final adder


def kara_row_ops(n: int) -> int:
    """Integer operations a row of N limbs of either Karatsuba kernel
    issues (``csrc/kara_rows.cuh`` ``KaraRows``): 2 a limb
    product of T0, T1 and T2 (one wide multiply-add, a 64-bit result), 4
    a 64-bit column carried (add with carry out and in, mask, shift), 4
    a limb of the two half sums (two adds, mask, shift), 2 a placed limb
    of T0 and of T1 (add and subtract), 1 of T2, and 3 a column of the
    final carry pass."""
    h, hp = n // 2, n // 2 + 1
    return (2 * (2 * h * h + hp * hp)
            + 4 * (2 * (2 * h - 1) + 2 * hp - 1)
            + 4 * 2 * h
            + 2 * 2 * 2 * h + min(2 * hp, 2 * n - h)
            + 3 * 2 * n)


def bound_ms(n_bytes: int, n_ops: int, ops_kind: str = "int32") -> tuple:
    """(ms, "bytes" or "operations"): the least time the H100 could take
    for ``n_bytes`` of device memory and ``n_ops`` operations of
    ``ops_kind``, the larger of the two."""
    t_bytes = n_bytes / h100.HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[ops_kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
