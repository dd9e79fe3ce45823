"""Static dataflow analyzer for every CUDA launch a plan implies.

Counterpart of the reference's ``verify/dataflow.py``.  The folded
schedules are only correct if their *memory* behavior is: the fused
kernel multiplies every instance's padded row block under one window
table, and the dispatch gathers operand rows into those blocks and
reads the products back -- exactly where an out-of-bounds window, a row
two blocks write, or a product read back from a padding row would
corrupt products without any test noticing (a wrong schedule can still
be bit-exact on the batches a test happens to draw).  This module
proves, per launch and *without executing it*, from the kernel
package's declared :class:`~repro_torch.kernels.introspect.LaunchContract`:

  conformance  the grid, threads, path and dynamic shared memory that
               the launcher's mirror (``introspect.launch_shape``, the
               arithmetic of ``csrc/``'s ``*_launch_shape`` entries)
               gives for the launch's arguments equal the declaration
               (on the card ``python -m repro_torch.verify --device
               cuda`` holds it to the built kernels themselves);
  bounds       every block's operand spans lie inside the operands'
               extents, every output row it writes below the output's
               rows; on the bulk path every copy is whole 16-byte units
               at 16-byte offsets; every window ``(lo, hi)`` respects
               the super-geometry (:func:`check_window_table`);
  hazards      every output row of a launch is written by exactly one
               block; the fused dispatch's gather lies in the batch,
               its read-back map takes every op from a distinct row
               computed from that op's operands (never a padding row);
               declared-idle steps add nothing to any limb's weight;
  shared mem   the launch's dynamic shared memory stays within the
               package's declared model, and both within a budget (the
               H100's 227 KiB opt-in a block; the role of the
               reference's ``verify/vmem.py``);
  roofline     the bytes (operands read once, products written once)
               and integer operations of the launch, counted as
               ``PERF.md`` section 6 counts its bounds: ``bound_ms``
               and ``arith_intensity``.

An unknown launcher or path is an ``analyzer-gap`` violation, never a
pass.  Reports are cached per distinct launch geometry.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.kernels import _row_tiles, introspect
from repro_torch.kernels._build import MAX_LIMBS
from repro_torch.kernels.prefix_adder.kernel import MAX_WIDTH
from repro_torch.verify.intervals import Violation

_ANALYZER = "dataflow"

#: ragged/prime batch sizes the tiler must produce safe launches for
RAGGED_BATCHES = (8, 56, 64, 100, 256, 512, 513, 977)
#: default shared-memory budget a block: the H100's opt-in limit
DEFAULT_SMEM_BUDGET = introspect.H100_SMEM_OPTIN
#: findings of one rule reported one by one before the rest are counted
_SHOWN = 4


@dataclasses.dataclass(frozen=True)
class LaunchReport:
    """Static analysis result of one CUDA launch."""
    name: str
    kernel: str
    path: str
    grid: tuple
    block: int
    n_blocks: int
    flops: int                  # integer (int8: tensor-core) operations
    hbm_bytes: int
    arith_intensity: float
    bound_ms: float
    bound_by: str
    smem: dict                  # dynamic, model and budget bytes
    smem_model_bytes: int
    violations: tuple

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid"] = list(self.grid)
        d["ok"] = self.ok
        d["violations"] = [dataclasses.asdict(v) for v in self.violations]
        return d


class _Findings:
    """Violations of one launch, at most :data:`_SHOWN` a rule, with the
    count of the rest in a last one."""

    def __init__(self):
        self.out, self._count = [], {}

    def add(self, rule, where, detail):
        n = self._count[rule] = self._count.get(rule, 0) + 1
        if n <= _SHOWN:
            self.out.append(Violation(_ANALYZER, rule, where, detail))

    def close(self, name) -> tuple:
        for rule, n in self._count.items():
            if n > _SHOWN:
                self.out.append(Violation(
                    _ANALYZER, rule, name,
                    f"... and {n - _SHOWN} more of the same rule"))
        return tuple(self.out)


# ------------------------------------------------------------ analysis

def analyze_contract(contract, budget=None) -> LaunchReport:
    """Full static analysis of one declared launch -> LaunchReport.

    Proves conformance to the launcher's arithmetic, bounds, hazards,
    the window table and idle steps, the shared-memory model and budget,
    and gives the static roofline.
    """
    c = contract
    budget = DEFAULT_SMEM_BUDGET if budget is None else budget
    found = _Findings()
    smem = {"dynamic_bytes": c.smem_bytes, "model_bytes": c.smem_model_bytes,
            "budget_bytes": budget}

    def report(flops=0, hbm=0, bound=(0.0, "bytes")):
        return LaunchReport(
            name=c.name, kernel=c.kernel, path=c.path, grid=tuple(c.grid),
            block=c.block, n_blocks=int(np.prod(c.grid)), flops=flops,
            hbm_bytes=hbm, arith_intensity=flops / hbm if hbm else 0.0,
            bound_ms=bound[0], bound_by=bound[1], smem=smem,
            smem_model_bytes=c.smem_model_bytes,
            violations=found.close(c.name))

    if c.path not in introspect.LAUNCHERS.get(c.kernel, (None, ()))[1]:
        found.add("analyzer-gap", c.name, f"launcher {c.kernel!r} with "
                  f"path {c.path!r} is not modeled")
        return report()
    la, lb = c.meta.get("la", 0), c.meta.get("lb", 0)
    if max(la, lb) > MAX_LIMBS or (
            c.kernel == "prefix_adder_launch"
            and c.operands["cols"].cols > MAX_WIDTH):
        found.add("launch-width", c.name, f"{c.kernel} takes rows of at "
                  f"most {MAX_LIMBS} limbs ({MAX_WIDTH} columns for the "
                  f"prefix adder); the wrapper refuses this launch")
        return report()

    # -- conformance against the launcher's arithmetic ------------------
    try:
        grid, block, dyn = introspect.launch_shape(c.kernel, c.launch_args)
    except ValueError as e:
        found.add("launch-refused", c.name, str(e))
        return report()
    if (tuple(grid), block, dyn) != (tuple(c.grid), c.block, c.smem_bytes):
        found.add("grid-mismatch", c.name,
                  f"declared grid {tuple(c.grid)}, {c.block} threads, "
                  f"{c.smem_bytes} B of shared memory; the launcher makes "
                  f"grid {tuple(grid)}, {block} threads, {dyn} B")
        return report()

    # -- window table and idle steps (fused launches) --------------------
    sg = c.meta.get("super_geometry")
    if sg is not None:
        table_faults = check_window_table(sg, c.table)
        for v in table_faults:
            found.add(v.rule, v.where, v.detail)
        if not any(v.rule == "window-shape" for v in table_faults):
            _idle_steps(c, found)

    # -- shared memory: the model and the budget -------------------------
    if c.smem_bytes > c.smem_model_bytes:
        found.add("smem-model", c.name,
                  f"dynamic shared memory {c.smem_bytes} B exceeds the "
                  f"declared per-block model {c.smem_model_bytes} B")
    if max(c.smem_bytes, c.smem_model_bytes) > budget:
        found.add("smem-budget", c.name,
                  f"{max(c.smem_bytes, c.smem_model_bytes)} B of shared "
                  f"memory a block exceeds the budget {budget} B")

    # -- bounds and write coverage, block by block -----------------------
    try:
        _blocks(c, found)
    except KeyError as e:
        found.add("analyzer-gap", c.name, f"block walk touches {e}, which "
                  f"the contract does not declare")
        return report()

    # -- the fused dispatch's gather and read-back maps ------------------
    if "gather" in c.meta:
        _dispatch_maps(c, found)

    # -- static roofline -------------------------------------------------
    skip = c.meta.get("roofline_skip", ())
    hbm = (sum(op.nbytes for name, op in c.operands.items()
               if name not in skip)
           + sum(op.nbytes for op in c.outputs.values()))
    flops = int(c.meta["ops"])
    return report(flops, hbm, introspect.bound_ms(hbm, flops,
                                                  c.meta["ops_kind"]))


def _idle_steps(c, found) -> None:
    """Declared-idle (instance, step) pairs must add no B limb: the
    kernel weighs limb jb of an instance once for every window (lo, hi)
    of its table with lo <= jb < hi, over the limbs it is compiled for."""
    table = np.asarray(c.table)
    width = c.meta["la"] if c.path == "bulk" else _row_tiles.bucket(
        c.meta["la"], c.meta["lb"])
    limb = np.arange(width)
    for i, j in c.idle_steps:
        lo, hi = int(table[i, j, 0]), int(table[i, j, 1])
        held = limb[(limb >= lo) & (limb < hi)]
        if held.size:
            found.add("idle-step-effect", f"{c.name} step ({i}, {j})",
                      f"declared-idle step adds B limbs {held.tolist()} of "
                      f"instance {i} to its accumulator despite its mask")


def _blocks(c, found) -> None:
    """Every region of every block inside its operand; bulk copies whole
    16-byte units at 16-byte offsets; each output row written once."""
    refs = {**c.operands, **c.outputs}
    counts = {}
    for name, out in c.outputs.items():
        counts[name] = np.zeros(out.rows, np.int32)
    bulk = c.path == "bulk"
    for work in c.blocks():
        where = f"{c.name} block {work.block}"
        for kind, regions in (("reads", work.reads), ("writes", work.writes)):
            for name, (r0, r1), (c0, c1) in regions:
                ref = refs[name]
                if r0 >= r1 or c0 >= c1:
                    continue
                if r0 < 0 or r1 > ref.rows or c0 < 0 or c1 > ref.cols:
                    found.add("block-bounds", where,
                              f"{kind} {name}[{r0}:{r1}, {c0}:{c1}] outside "
                              f"its {ref.rows} x {ref.cols} extent")
                    continue
                if bulk and name != "table":
                    row_bytes = ref.cols * ref.itemsize
                    if (r0 * row_bytes % 16 or (r1 - r0) * row_bytes % 16
                            or (c0, c1) != (0, ref.cols)):
                        found.add("block-bounds", where,
                                  f"bulk copy of {name}[{r0}:{r1}] is not "
                                  f"whole 16-byte units at a 16-byte offset")
                if kind == "writes":
                    if (c0, c1) == (0, ref.cols):
                        counts[name][r0:r1] += 1
                    else:
                        counts.setdefault((name, "cells"), np.zeros(
                            (ref.rows, ref.cols), np.int16))[r0:r1, c0:c1] += 1
    for name, cnt in counts.items():
        if isinstance(name, tuple):
            continue
        cells = counts.get((name, "cells"))
        if cells is not None:
            cnt = cells + cnt[:, None]
        twice = np.argwhere(cnt > 1)
        if twice.size:
            found.add("waw", f"{c.name} {name} row {int(twice[0][0])}",
                      f"{len(twice)} output elements are written by more "
                      f"than one block")
        never = np.argwhere(cnt == 0)
        if never.size:
            found.add("unwritten-row", f"{c.name} {name} row "
                      f"{int(never[0][0])}", f"{len(never)} output elements "
                      f"are written by no block")


def _dispatch_maps(c, found) -> None:
    """``make_fused_dispatch``'s maps: gather in [0, batch); source a
    one-to-one map of the ops onto rows; each op's row a real row of its
    instance, gathered from that op's operands."""
    gather = np.asarray(c.meta["gather"])
    source = np.asarray(c.meta["source"])
    batch, rows = c.meta["batch"], c.meta["rows"]
    n_ops = np.asarray(c.meta["n_ops"])
    where = f"{c.name} dispatch"
    bad = np.argwhere((gather < 0) | (gather >= batch))
    if bad.size:
        i, r = (int(x) for x in bad[0])
        found.add("gather-bounds", where,
                  f"{len(bad)} block rows gather an op outside [0, {batch}),"
                  f" first row {r} of instance {i} (op {int(gather[i, r])})")
    if source.shape != (batch,) or ((source < 0)
                                    | (source >= gather.size)).any():
        found.add("source-map", where, f"read-back map of shape "
                  f"{source.shape} leaves the {gather.size} block rows")
        return
    if len(np.unique(source)) != batch:
        found.add("source-map", where,
                  "two ops read their products back from one row")
    inst, row = np.divmod(source, rows)
    ops = np.arange(batch)
    padding = np.flatnonzero(row >= n_ops[inst])
    if padding.size:
        op = int(padding[0])
        found.add("read-before-write", where,
                  f"{padding.size} ops read a padding row back, first op "
                  f"{op} from row {int(row[op])} of instance "
                  f"{int(inst[op])}, which holds {int(n_ops[inst[op]])} ops")
    foreign = np.flatnonzero(gather[inst, row] != ops)
    if foreign.size:
        op = int(foreign[0])
        found.add("read-before-write", where,
                  f"{foreign.size} ops read back a product computed for "
                  f"another op, first op {op} from row {int(row[op])} of "
                  f"instance {int(inst[op])} (gathered for op "
                  f"{int(gather[inst[op], row[op]])})")


# ----------------------------------------------------- window-table rules

def check_window_table(sg, table=None) -> list:
    """Static rules over a fused launch's window table.

    Checked directly on the (instance, step, 2) table so seeded
    corruptions (tests) and the real :meth:`SuperGeometry.table` go
    through one code path:

      window-shape     table shape matches the super-geometry
      window-bounds    0 <= lo <= hi <= LB on every real step
      window-empty     real steps consume at least one limb
      window-overlap   one instance's real windows are pairwise disjoint
      window-coverage  they cover every B limb exactly once
      idle-unmasked    padded idle steps carry the (0, 0) mask
    """
    tbl = np.asarray(sg.table() if table is None else table)
    out = []
    want = (sg.n_instances, sg.max_steps, 2)
    if tbl.shape != want:
        out.append(Violation(
            _ANALYZER, "window-shape", f"fused[{sg.la}x{sg.lb}]",
            f"window table shape {tbl.shape}, super-geometry "
            f"requires {want}"))
        return out
    for i in range(sg.n_instances):
        real = sg.rows[i].ct_run
        covered = np.zeros(sg.lb, int)
        for j in range(sg.max_steps):
            lo, hi = int(tbl[i, j, 0]), int(tbl[i, j, 1])
            where = f"fused[{sg.la}x{sg.lb}] instance {i} step {j}"
            if j >= real:
                if (lo, hi) != (0, 0):
                    out.append(Violation(
                        _ANALYZER, "idle-unmasked", where,
                        f"padded idle step carries window "
                        f"({lo}, {hi}) instead of the (0, 0) mask"))
                continue
            if not (0 <= lo <= hi <= sg.lb):
                out.append(Violation(
                    _ANALYZER, "window-bounds", where,
                    f"window ({lo}, {hi}) outside [0, {sg.lb}]"))
                continue
            if lo == hi:
                out.append(Violation(
                    _ANALYZER, "window-empty", where,
                    "real fold step consumes no B limbs"))
                continue
            covered[lo:hi] += 1
        if (covered > 1).any():
            dup = int(np.argmax(covered > 1))
            out.append(Violation(
                _ANALYZER, "window-overlap",
                f"fused[{sg.la}x{sg.lb}] instance {i}",
                f"B limb {dup} accumulated by overlapping windows -- "
                f"its partial products would be added twice"))
        elif (covered == 0).any():
            miss = int(np.argmax(covered == 0))
            out.append(Violation(
                _ANALYZER, "window-coverage",
                f"fused[{sg.la}x{sg.lb}] instance {i}",
                f"B limb {miss} not covered by any window"))
    return out


# --------------------------------------------------------- plan-level API

def _instance_params(cfg) -> tuple:
    """(schedule, ct) of the mcim_fold launch realizing one config."""
    if cfg.arch == "star":
        return "fb", 1
    if cfg.arch == "karatsuba":
        return "karatsuba", 3
    return cfg.arch, cfg.ct


def _flat_configs(configs) -> tuple:
    flat = []
    for count, cfg in configs:
        flat.extend([cfg] * count)
    return tuple(flat)


@functools.lru_cache(maxsize=2048)
def _kernel_contract(la, lb, schedule, ct, batch=256):
    from repro_torch.kernels import mcim_fold
    return mcim_fold.launch_contract(la, lb, ct, schedule, batch=batch)


@functools.lru_cache(maxsize=2048)
def _fused_contract(la, lb, cts):
    from repro_torch.core.mcim import MCIMConfig
    from repro_torch.kernels import bank_fold
    configs = tuple(MCIMConfig(arch="fb", ct=ct) for ct in cts)
    return bank_fold.launch_contract(configs, la, lb)


@functools.lru_cache(maxsize=2048)
def _kernel_report(la, lb, schedule, ct, batch=256, budget=None):
    return analyze_contract(_kernel_contract(la, lb, schedule, ct, batch),
                            budget=budget)


@functools.lru_cache(maxsize=2048)
def _fused_report(la, lb, cts, budget=None):
    return analyze_contract(_fused_contract(la, lb, cts), budget=budget)


def clear_caches() -> None:
    """Forget every cached contract and report (a patched geometry or
    table is then analyzed afresh)."""
    for fn in (_kernel_contract, _fused_contract, _kernel_report,
               _fused_report):
        fn.cache_clear()


def _plan_launches(bits_a: int, bits_b: int, configs, substrate: str):
    """(fused?, geometry key) of every distinct launch a plan implies."""
    from repro_torch.core import limbs as L
    from repro_torch.kernels.bank_fold import fused_ct
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    flat = _flat_configs(configs)
    if substrate == "fused":
        return ((True, (la, lb, tuple(fused_ct(cfg) for cfg in flat))),)
    if substrate != "kernel":
        raise ValueError(f"substrate must be kernel or fused, "
                         f"got {substrate!r}")
    params = dict.fromkeys(_instance_params(cfg) for cfg in flat)
    return tuple((False, (la, lb, schedule, ct)) for schedule, ct in params)


def plan_contracts(bits_a: int, bits_b: int, configs,
                   substrate: str = "fused") -> tuple:
    """The contracts of every distinct launch a plan implies:
    ``substrate="kernel"`` one per-instance ``mcim_fold`` launch per
    distinct (schedule, CT) in the plan, ``"fused"`` the one bank_fold
    launch of the whole bank.  Signed configs declare the unsigned
    launches: the correction pass is torch ops outside the kernels."""
    return tuple(_fused_contract(*key) if fused else _kernel_contract(*key)
                 for fused, key in _plan_launches(bits_a, bits_b, configs,
                                                  substrate))


def analyze_plan(bits_a: int, bits_b: int, configs,
                 substrate: str = "fused", budget=None) -> tuple:
    """LaunchReports of every distinct launch a plan implies (see
    :func:`plan_contracts`)."""
    return tuple(_fused_report(*key, budget) if fused
                 else _kernel_report(*key, budget=budget)
                 for fused, key in _plan_launches(bits_a, bits_b, configs,
                                                  substrate))


def verify_plan_dataflow(bits_a: int, bits_b: int, configs,
                         budget=None) -> tuple:
    """All dataflow violations of a plan, both substrates."""
    out = []
    for substrate in ("kernel", "fused"):
        for rep in analyze_plan(bits_a, bits_b, configs,
                                substrate=substrate, budget=budget):
            out.extend(rep.violations)
    return tuple(out)


def plan_static_stats(bits_a: int, bits_b: int, configs, batch=None,
                      scheduler="round_robin") -> dict:
    """Fused-launch roofline numbers of a plan (benchmark columns): the
    gate's launch, or with ``batch`` the launch of a round of ``batch``
    ops under ``scheduler`` (``chip_smoke.py`` phase 2's blocks)."""
    if batch is None:
        rep = analyze_plan(bits_a, bits_b, configs, substrate="fused")[0]
    else:
        rep = analyze_contract(round_contract(bits_a, bits_b, configs,
                                              batch, scheduler))
    return {
        "smem_bytes_block": rep.smem["dynamic_bytes"],
        "smem_model_bytes": rep.smem_model_bytes,
        "flops_per_launch": rep.flops,
        "hbm_bytes_per_launch": rep.hbm_bytes,
        "arith_intensity": rep.arith_intensity,
        "bound_ms": rep.bound_ms,
        "bound_by": rep.bound_by,
        "ok": rep.ok,
    }


def round_contract(bits_a: int, bits_b: int, configs, batch: int,
                   scheduler="round_robin"):
    """The fused launch of one bank round of ``batch`` ops, assigned by
    ``scheduler`` as ``Bank.dispatch_fn`` assigns them."""
    from repro_torch.core import limbs as L
    from repro_torch.core.bank.schedule import get_scheduler
    from repro_torch.kernels import bank_fold
    flat = _flat_configs(configs)
    assign, _ = get_scheduler(scheduler).schedule(
        tuple(cfg.ct for cfg in flat), batch)
    return bank_fold.launch_contract(flat, L.n_limbs_for_bits(bits_a),
                                     L.n_limbs_for_bits(bits_b),
                                     assign=assign)


def standalone_contracts() -> tuple:
    """Contracts of the non-bank kernels (full-tree coverage)."""
    from repro_torch.kernels import int8_matmul, karatsuba_ppm, prefix_adder
    return (karatsuba_ppm.launch_contract(4),
            prefix_adder.launch_contract(16),
            int8_matmul.launch_contract())


def analyze_standalone(budget=None) -> tuple:
    """LaunchReports of the non-bank kernels (full-tree coverage)."""
    return tuple(analyze_contract(c, budget=budget)
                 for c in standalone_contracts())


def analyze_tiling(bits: int = 32, batches=RAGGED_BATCHES,
                   budget=None) -> tuple:
    """Bounds/hazard proofs across ragged batch shapes of the tiler."""
    from repro_torch.core import limbs as L
    la = L.n_limbs_for_bits(bits)
    return tuple(_kernel_report(la, la, "fb", 2, batch=b, budget=budget)
                 for b in batches)


# ------------------------------------------------------------ the card

def check_on_card(contract) -> tuple:
    """Hold one contract to the built kernel on the current CUDA card:
    the launcher's ``*_launch_shape`` for the contract's arguments must
    equal the declared grid, threads and dynamic shared memory
    (``card-launch-shape``), the kernel it launches must spill nothing
    (``spills``: local bytes 0), take the declared threads
    (``block-limit``) and fit its static plus dynamic shared memory in
    the card's opt-in limit (``smem-optin``).  Returns (record,
    violations)."""
    import torch
    from repro_torch.kernels import _build
    c = contract
    where = f"{c.name} on the card"
    try:
        shape = _build.query(c.lib, c.shape_symbol, c.launch_args)
        attrs = _build.query(c.lib, c.attributes_symbol, c.launch_args)
    except RuntimeError as e:
        return ({"launch": c.name, "ok": False}, [Violation(
            _ANALYZER, "launch-refused", where, str(e))])
    optin = torch.cuda.get_device_properties(
        torch.cuda.current_device()).shared_memory_per_block_optin
    declared = (*c.grid, c.block, c.smem_bytes)
    out = []
    if tuple(shape) != tuple(declared):
        out.append(Violation(
            _ANALYZER, "card-launch-shape", where,
            f"declared (grid.x, grid.y, threads, shared bytes) {declared},"
            f" {c.shape_symbol} gives {tuple(shape)}"))
    regs, local, static, max_threads = attrs
    if local:
        out.append(Violation(_ANALYZER, "spills", where,
                             f"{local} B of local memory a thread"))
    if max_threads < c.block:
        out.append(Violation(_ANALYZER, "block-limit", where,
                             f"the kernel takes at most {max_threads} "
                             f"threads a block, the launch {c.block}"))
    if static + shape[3] > optin:
        out.append(Violation(_ANALYZER, "smem-optin", where,
                             f"{static} B static + {shape[3]} B dynamic "
                             f"shared memory exceed the card's {optin} B"))
    record = {"launch": c.name, "kernel": c.kernel, "path": c.path,
              "declared": list(declared), "card": list(shape),
              "registers": regs, "local_bytes": local,
              "static_smem_bytes": static, "max_threads": max_threads,
              "ok": not out}
    return record, out
