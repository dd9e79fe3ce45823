"""Schedule-contract checking: does the design compute A*B, and does the
machinery around it keep its static promises?

A copy of the reference package's ``verify/contracts.py``: every check
and violation string is the same, over the port's geometry and
scheduler registry, except :func:`check_bank_static` (see there).

Four independent contracts, all checkable without executing a multiply:

coverage
    Every folded schedule must touch every partial product a_i * b_j
    exactly once at weight 2**(16*(i+j)).  For fb/ff the per-cycle
    B-windows from :func:`~repro_torch.kernels.mcim_fold.fold_geometry` are
    checked symbolically as a bilinear form; for Karatsuba the combine
    step ``T0 + T1<<2h + (T2-T1-T0)<<h`` is expanded as a polynomial
    identity over free symbols A0/A1/B0/B1 (the signed NOT+1 encodings
    cancel exactly like the hardware's wraps do), per recursion level.

widths
    The kernel's declared scratch/out widths must dominate the widths
    the interval analyzer (:mod:`.intervals`) proves the dataflow needs.
    A scratch one column too narrow silently truncates a compress -- the
    classic folded-multiplier bug this contract exists to reject.

throughput
    A ``planner.Plan``'s instance throughputs (count / CT each) must sum
    exactly to ``Plan.throughput`` as Fractions.

schedulers / bank staticness
    Every registered :class:`~repro_torch.core.bank.schedule.Scheduler`
    must map (cts, n_ops) to a deterministic assignment that covers
    ``range(n_ops)`` exactly once with a makespan no smaller than its
    busiest instance; a ``Bank`` must build, return the full product
    shape and schedule the same assignment twice.
"""
from __future__ import annotations

from fractions import Fraction

from repro_torch.core import limbs as L
from repro_torch.core.mcim import MCIMConfig
from repro_torch.core.bank.schedule import SCHEDULERS
from repro_torch.kernels.mcim_fold import fold_geometry
from repro_torch.kernels.bank_fold.geometry import (fused_windows,
                                              super_geometry)

from . import intervals
from .intervals import Violation


# ------------------------------------------------------------- coverage

def coverage_form(la: int, lb: int, windows) -> dict:
    """Bilinear form of a windowed schoolbook schedule.

    Cycle ``t`` of an fb/ff fold computes ``A * B[lo:hi]`` and retires it
    at limb offset ``lo``, contributing ``a_i * b_j * 2**(16*(i+j))`` for
    every ``j`` in the window.  The returned dict maps ``(i, j)`` to the
    coefficient in units of the target weight ``2**(16*(i+j))`` -- a
    correct schedule yields exactly 1 everywhere.
    """
    form = {}
    for lo, hi in windows:
        for j in range(lo, min(hi, lb)):
            for i in range(la):
                form[(i, j)] = form.get((i, j), 0) + 1
    return form


def check_windows(la: int, lb: int, windows, where: str) -> list:
    """Coverage violations of one windowed schedule (fb/ff/star)."""
    form = coverage_form(la, lb, windows)
    out = []
    for i in range(la):
        for j in range(lb):
            coeff = form.pop((i, j), 0)
            if coeff == 0:
                out.append(Violation(
                    "contracts", "missing-product", where,
                    f"partial product a[{i}]*b[{j}] is never computed"))
            elif coeff != 1:
                out.append(Violation(
                    "contracts", "double-cover", where,
                    f"partial product a[{i}]*b[{j}] accumulated "
                    f"{coeff} times"))
    for (i, j), coeff in form.items():
        out.append(Violation(
            "contracts", "out-of-range", where,
            f"schedule touches nonexistent product a[{i}]*b[{j}] "
            f"({coeff}x)"))
    return out


def _poly_mul(p: dict, q: dict) -> dict:
    out = {}
    for (ma, sa), ca in p.items():
        for (mb, sb), cb in q.items():
            key = (tuple(sorted(ma + mb)), sa + sb)
            out[key] = out.get(key, 0) + ca * cb
    return out


def _poly_add(p: dict, q: dict, scale: int = 1, shift: int = 0) -> dict:
    out = dict(p)
    for (m, s), c in q.items():
        key = (m, s + shift)
        out[key] = out.get(key, 0) + scale * c
        if out[key] == 0:
            del out[key]
    return out


def check_karatsuba_identity(half: int, where: str) -> list:
    """Expand the combine step symbolically and compare against A*B.

    Polynomials live over monomials ((symbols...), limb_shift): the
    value is sum(coeff * prod(symbols) * 2**(16*shift)).  With
    A = A0 + A1<<h and T2 = (A0+A1)(B0+B1), the combine
    ``T0 + T1<<2h + T2<<h - T1<<h - T0<<h`` (the subtractions being what
    the NOT+1 columns encode mod the wrap) must equal A*B identically.
    """
    sym = lambda name: {((name,), 0): 1}
    a0, a1, b0, b1 = sym("A0"), sym("A1"), sym("B0"), sym("B1")
    t0 = _poly_mul(a0, b0)
    t1 = _poly_mul(a1, b1)
    t2 = _poly_mul(_poly_add(a0, a1), _poly_add(b0, b1))
    combine = {}
    combine = _poly_add(combine, t0)
    combine = _poly_add(combine, t1, shift=2 * half)
    combine = _poly_add(combine, t2, shift=half)
    combine = _poly_add(combine, t1, scale=-1, shift=half)
    combine = _poly_add(combine, t0, scale=-1, shift=half)
    target = _poly_mul(_poly_add(a0, a1, shift=half),
                       _poly_add(b0, b1, shift=half))
    diff = _poly_add(combine, target, scale=-1)
    if diff:
        return [Violation(
            "contracts", "karatsuba-identity", where,
            f"combine step differs from A*B by {diff}")]
    return []


def check_coverage(bits_a: int, bits_b: int, cfg: MCIMConfig,
                   windows=None) -> list:
    """Partial-product coverage of one instance's folded schedule.

    ``windows`` overrides the geometry-derived per-cycle B-windows
    (fb/ff only) so tests can seed corrupted schedules.
    """
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    where = f"{cfg.arch}(ct={cfg.ct}) {bits_a}x{bits_b}b"
    if cfg.arch == "star":
        return check_windows(la, lb, ((0, lb),), where)
    if cfg.arch in ("fb", "ff"):
        geo = fold_geometry(la, lb, cfg.ct, cfg.arch)
        wins = geo.b_windows if windows is None else tuple(windows)
        out = check_windows(la, lb, wins, where)
        if windows is None and geo.ct_run * geo.chunk < lb:
            out.append(Violation(
                "contracts", "grid-undercover", where,
                f"{geo.ct_run} grid steps x {geo.chunk}-limb chunks "
                f"cover only {geo.ct_run * geo.chunk} of {lb} B limbs"))
        return out
    if cfg.arch == "karatsuba":
        out = []
        n = max(la, lb)
        for level in range(cfg.levels):
            n += n % 2
            half = n // 2
            if half < 1:
                break
            out.extend(check_karatsuba_identity(
                half, f"{where} level {level}"))
            n = half + 1          # next level splits the shared-PPM port
        return out
    return [Violation("contracts", "unknown-arch", where,
                      f"no coverage model for arch {cfg.arch!r}")]


# ---------------------------------------------------------------- widths

def check_widths(bits_a: int, bits_b: int, cfg: MCIMConfig,
                 scratch_width=None, out_width=None) -> list:
    """Kernel scratch/out widths vs the interval analyzer's requirement.

    ``scratch_width``/``out_width`` override the geometry's declared
    values so tests can seed a scratch one column too narrow.
    """
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    where = f"{cfg.arch}(ct={cfg.ct}) {bits_a}x{bits_b}b"
    schedule = {"star": "fb", "fb": "fb", "ff": "ff",
                "karatsuba": "karatsuba"}.get(cfg.arch)
    if schedule is None:
        return [Violation("contracts", "unknown-arch", where,
                          f"no kernel geometry for arch {cfg.arch!r}")]
    ct = 1 if cfg.arch == "star" else (3 if cfg.arch == "karatsuba"
                                       else cfg.ct)
    geo = fold_geometry(la, lb, ct, schedule)
    declared_scratch = geo.scratch_width if scratch_width is None \
        else scratch_width
    declared_out = geo.out_width if out_width is None else out_width
    required = intervals.required_scratch_width(bits_a, bits_b, cfg,
                                                substrate="kernel")
    out = []
    if declared_scratch < required:
        out.append(Violation(
            "contracts", "scratch-too-narrow", where,
            f"declared scratch holds {declared_scratch} columns but the "
            f"interval analysis needs {required}: the compress would "
            f"silently truncate high columns"))
    if declared_out != la + lb:
        out.append(Violation(
            "contracts", "out-width", where,
            f"declared out width {declared_out} != product width "
            f"{la + lb}"))
    return out


# ----------------------------------------------------------------- fused

def check_fused_schedule(bits_a: int, bits_b: int, cfg: MCIMConfig,
                         windows=None) -> list:
    """Coverage of one instance's fused-megakernel window schedule.

    The fused datapath is a windowed schoolbook for EVERY arch
    (Karatsuba included: its CT=3 fused row is three B-windows, not the
    combine identity), so the bilinear-form check applies uniformly.
    ``windows`` overrides the geometry-derived schedule so tests can
    seed corrupted tables.
    """
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    where = f"fused {cfg.arch}(ct={cfg.ct}) {bits_a}x{bits_b}b"
    wins = fused_windows(cfg, la, lb) if windows is None else tuple(windows)
    return check_windows(la, lb, wins, where)


def check_fused_widths(bits_a: int, bits_b: int, cfg: MCIMConfig,
                       scratch_width=None, out_width=None) -> list:
    """Fused scratch/out widths vs the fused interval walk's requirement.

    Overrides let tests seed a scratch one column too narrow, the same
    silent-truncation bug class the per-instance widths contract
    rejects.
    """
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    where = f"fused {cfg.arch}(ct={cfg.ct}) {bits_a}x{bits_b}b"
    sg = super_geometry((cfg,), la, lb)
    declared_scratch = sg.scratch_width if scratch_width is None \
        else scratch_width
    declared_out = sg.out_width if out_width is None else out_width
    required = intervals.required_scratch_width(bits_a, bits_b, cfg,
                                                substrate="fused")
    out = []
    if declared_scratch < required:
        out.append(Violation(
            "contracts", "scratch-too-narrow", where,
            f"fused scratch holds {declared_scratch} columns but the "
            f"interval analysis needs {required}: the accumulator would "
            f"silently truncate high columns"))
    if declared_out != la + lb:
        out.append(Violation(
            "contracts", "out-width", where,
            f"fused out width {declared_out} != product width {la + lb}"))
    return out


def check_fused_plan(bits_a: int, bits_b: int, configs) -> list:
    """Bank-level contracts of the fused super-geometry.

    ``configs`` is the plan's ``(count, cfg)`` list.  Beyond the
    per-instance coverage/width contracts, the super-geometry itself
    promises: every padded row step beyond an instance's real fold is
    the idle mask ``(0, 0)`` (so heterogeneous CTs are architectural
    no-ops, not garbage accumulation), and the materialized SMEM table
    agrees entry-for-entry with the per-row windows the coverage proof
    ran over.
    """
    la = L.n_limbs_for_bits(bits_a)
    lb = L.n_limbs_for_bits(bits_b)
    flat = tuple(cfg for count, cfg in configs for _ in range(count))
    where = f"fused bank {bits_a}x{bits_b}b ({len(flat)} instances)"
    if not flat:
        return [Violation("contracts", "fused-empty-bank", where,
                          "fused launch needs at least one instance")]
    sg = super_geometry(flat, la, lb)
    out = []
    table = sg.table()
    for i, (cfg, geo) in enumerate(zip(sg.configs, sg.rows)):
        wins = sg.windows(i)
        if len(wins) != sg.max_steps:
            out.append(Violation(
                "contracts", "fused-row-length", where,
                f"instance {i} has {len(wins)} padded steps, grid "
                f"expects {sg.max_steps}"))
        for j in range(geo.ct_run, sg.max_steps):
            if wins[j] != (0, 0):
                out.append(Violation(
                    "contracts", "fused-idle-mask", where,
                    f"instance {i} idle step {j} is {wins[j]}, not the "
                    f"(0, 0) mask -- it would accumulate garbage"))
        for j, (lo, hi) in enumerate(wins):
            if tuple(table[i, j]) != (lo, hi):
                out.append(Violation(
                    "contracts", "fused-table-mismatch", where,
                    f"SMEM table[{i}, {j}] = {tuple(table[i, j])} "
                    f"differs from geometry window {(lo, hi)}"))
        if geo.scratch_width != sg.scratch_width or \
                geo.out_width != sg.out_width:
            out.append(Violation(
                "contracts", "fused-row-width", where,
                f"instance {i} declares scratch/out "
                f"{geo.scratch_width}/{geo.out_width}, super-geometry "
                f"shares {sg.scratch_width}/{sg.out_width}"))
    return out


# ------------------------------------------------------------ throughput

def check_throughput(configs, throughput, where: str = "plan") -> list:
    """Instance throughputs (count/CT each) must sum exactly to the
    plan's aggregate -- Fractions, no float slack."""
    achieved = sum((Fraction(count, cfg.ct) for count, cfg in configs),
                   Fraction(0))
    if achieved != Fraction(throughput):
        return [Violation(
            "contracts", "throughput-sum", where,
            f"instance throughputs sum to {achieved}, plan claims "
            f"{Fraction(throughput)}")]
    return []


# ------------------------------------------------------------ schedulers

#: (cts, n_ops) cases every registered scheduler is checked against;
#: mixes homogeneous, heterogeneous and degenerate banks
SCHEDULER_CASES = (
    ((1,), 0), ((1,), 7), ((2,), 5),
    ((1, 2), 9), ((1, 1, 1, 2), 11), ((2, 3), 8),
    ((1, 2, 3, 12), 25), ((12,), 3),
)


def check_scheduler(sched, cts: tuple, n_ops: int) -> list:
    """Determinism + completeness + makespan sanity of one policy."""
    where = f"scheduler {sched.name} cts={cts} n_ops={n_ops}"
    try:
        first = sched.schedule(cts, n_ops)
        second = sched.schedule(cts, n_ops)
    except Exception as e:                         # noqa: BLE001
        return [Violation("contracts", "scheduler-crash", where, repr(e))]
    out = []
    if first != second:
        out.append(Violation(
            "contracts", "scheduler-nondeterministic", where,
            "two identical calls returned different schedules; dispatch "
            "would recompile per call and break jit staticness"))
    assignment, makespan = first
    if len(assignment) != len(cts):
        out.append(Violation(
            "contracts", "scheduler-shape", where,
            f"{len(assignment)} instance lists for {len(cts)} instances"))
        return out
    flat = sorted(op for ops in assignment for op in ops)
    if flat != list(range(n_ops)):
        out.append(Violation(
            "contracts", "scheduler-coverage", where,
            f"assignment covers {flat[:8]}... not range({n_ops}) "
            f"exactly once"))
    busiest = max((len(ops) * ct for ops, ct in zip(assignment, cts)),
                  default=0)
    if makespan < busiest:
        out.append(Violation(
            "contracts", "scheduler-makespan", where,
            f"makespan {makespan} below the busiest instance's "
            f"{busiest} busy cycles"))
    if n_ops == 0 and makespan != 0:
        out.append(Violation(
            "contracts", "scheduler-makespan", where,
            f"empty batch reports makespan {makespan}"))
    return out


def check_all_schedulers(cases=SCHEDULER_CASES) -> list:
    out = []
    for sched in SCHEDULERS.values():
        for cts, n_ops in cases:
            out.extend(check_scheduler(sched, cts, n_ops))
    return out


# ---------------------------------------------------------- bank statics

def check_bank_static(plan, bits_a: int, bits_b: int,
                      backend: str = "core", batch: int = 8,
                      device="cpu") -> list:
    """Prove ``Bank.dispatch_fn`` is a function of static shapes only.

    The dispatch closure is built concretely on ``device``, its gather
    and read-back index tensors real, as the bank builds it; it then
    runs on *fake* operands of the static shape under
    ``FakeTensorMode``: tensors that carry shape, dtype and device but
    no data.  Success means no Python control flow inspected operand
    values (a branch on one raises ``DataDependentOutputException``)
    and the output shape is the full product batch.  On ``"cuda"`` the
    "kernel" and "fused" backends reach their custom ops' fake versions,
    so the CUDA route is proved too; on the CPU every backend runs its
    plain versions.  Assignment determinism across calls is checked via
    the scheduler contract; here we additionally diff the gather indices
    two independently-built dispatches close over.
    """
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.bank import Bank
    where = f"bank[{plan.describe()}] backend={backend}"
    try:
        bank = Bank(plan, bits_a, bits_b, backend=backend, device=device)
        run = bank.dispatch_fn(batch)
    except Exception as e:                         # noqa: BLE001
        return [Violation("contracts", "bank-construct", where, repr(e))]
    out = []
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = torch.empty((batch, bank.la), dtype=L.LIMB_DTYPE,
                            device=bank.device)
            b = torch.empty((batch, bank.lb), dtype=L.LIMB_DTYPE,
                            device=bank.device)
            shape = tuple(run(a, b).shape)
    except Exception as e:                         # noqa: BLE001
        return out + [Violation(
            "contracts", "bank-not-traceable", where,
            f"dispatch_fn failed under FakeTensorMode (operand-value "
            f"dependence or tracer leak): {e!r}")]
    if shape != (batch, bank.la + bank.lb):
        out.append(Violation(
            "contracts", "bank-out-shape", where,
            f"dispatch returns {shape}, expected "
            f"{(batch, bank.la + bank.lb)}"))
    assign1, _ = bank.scheduler.schedule(bank._cts, batch)
    assign2, _ = bank.scheduler.schedule(bank._cts, batch)
    if assign1 != assign2:
        out.append(Violation(
            "contracts", "bank-dispatch-unstable", where,
            "gather indices differ between two schedule calls for the "
            "same static batch"))
    return out


# ------------------------------------------------------------- aggregate

def check_plan(bits_a: int, bits_b: int, configs, throughput,
               substrates=("core", "kernel", "fused")) -> list:
    """Full contract sweep of one plan: throughput sum + per-instance
    coverage, widths and interval safety on every substrate, plus the
    fused super-geometry contracts when the fused substrate is swept."""
    out = list(check_throughput(configs, throughput))
    for _, cfg in configs:
        out.extend(check_coverage(bits_a, bits_b, cfg))
        out.extend(check_widths(bits_a, bits_b, cfg))
        for sub in substrates:
            if sub == "kernel" and cfg.signed:
                continue          # the kernel capability is unsigned-only
            rep = intervals.analyze(bits_a, bits_b, cfg, substrate=sub)
            out.extend(rep.violations)
        if "fused" in substrates:
            out.extend(check_fused_schedule(bits_a, bits_b, cfg))
            out.extend(check_fused_widths(bits_a, bits_b, cfg))
    if "fused" in substrates:
        out.extend(check_fused_plan(bits_a, bits_b, configs))
    return out
