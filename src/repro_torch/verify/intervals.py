"""Interval / overflow analysis: prove every uint32 column stays < 2**32.

A copy of the reference package's ``verify/intervals.py``, walks and
violation strings unchanged, so the port refuses exactly the plans the
reference refuses.  The arithmetic discipline (``core.limbs``) rests on
one invariant: carry-save column sums never overflow a uint32 lane.
This module is an *abstract interpreter* over the limb pipeline that
proves it per design, symbolically in (bits_a, bits_b, CT, schedule) --
no execution.

The abstract domain is a vector of per-column worst-case magnitudes
(exact Python ints, so no precision is lost at any width).  Each
analysis mirrors one architecture's dataflow step by step:

  * ``ppm`` scatters lo/hi product halves -> per-column sums of
    ``min(amax*bmax, MASK)`` / ``(amax*bmax) >> 16`` contributions;
  * ``compress`` adds bound vectors (uint32 addition of non-negative
    terms overflows iff the final bound does, so one check suffices);
  * the final adders thread a worst-case carry through the column walk,
    checking ``col + carry < 2**32`` at every position.

``analyze(bits_a, bits_b, cfg, substrate)`` walks the full design --
core (``mcim_mul``), kernel (the per-instance fold kernels, modelled as
the reference's TPU kernels compute them) or fused (the bank kernel) --
and returns an :class:`IntervalReport` with the worst column bound, the
headroom in bits, and the accumulator width the design *requires*
(checked against the declared scratch by :mod:`.contracts`).

Why the reference's bounds hold for the port:

  * the port's plain paths sum columns in ``int64`` (``core.limbs``),
    which holds every value below 2**32 exactly;
  * the CUDA kernels of ``csrc/bank_fold.cu`` and ``csrc/row_tiles.cuh``
    (bank_fold, FB, FF) sum in ``uint32``, but by one weighted schoolbook
    (``tiles::schoolbook``): B limb ``jb`` enters every column it feeds
    once for each fold step whose window holds it.  Those columns are
    the fused walk's final accumulator, which :func:`analyze` proves
    below 2**32 on the "fused" substrate for every instance (FB and FF
    at weight 1 on every limb are star's fused walk);
    :func:`analyze_row_tiles` walks that arithmetic itself, and the
    port's tests hold its bounds equal to the fused walk's;
  * ``KaraRows`` (``csrc/kara_rows.cuh``) sums its limb products in 64
    bits and combines canonical half products, so its uint32 columns
    stay below 6 * 2**16.

So every bound the reference proves below 2**32 holds for the port's
columns, and a plan this analysis accepts runs exactly on every
substrate of the port.

Soundness: every abstract op maps bound vectors to bound vectors that
dominate the concrete columns for ALL operand values of the given
widths (monotonicity of +, *, >>, and min against MASK).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import limbs as L
from repro_torch.core.mcim import MCIMConfig
from repro_torch.kernels.mcim_fold import fold_geometry
# geometry module directly: keeps verify import-light
from repro_torch.kernels.bank_fold.geometry import fused_windows

U32_MAX = L.U32_MAX

#: execution substrates a design can be proven for (cf. bank.backends)
SUBSTRATES = ("core", "kernel", "fused")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One provable-unsafety finding (shared by all three analyzers)."""
    analyzer: str             # intervals | contracts | lint
    rule: str                 # e.g. "u32-overflow", "double-cover"
    where: str                # pipeline site, e.g. "fb(ct=2) cycle 1"
    detail: str

    def describe(self) -> str:
        return f"[{self.analyzer}/{self.rule}] {self.where}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class IntervalReport:
    """Overflow-safety verdict for one (widths, config, substrate)."""
    bits_a: int
    bits_b: int
    config: MCIMConfig
    substrate: str
    ok: bool
    max_column: int           # worst bound over every intermediate column
    headroom_bits: float      # 32 - log2(max_column)
    required_width: int       # accumulator columns the design needs
    violations: tuple

    def describe(self) -> str:
        tag = "proved" if self.ok else "OVERFLOW"
        return (f"{tag} {self.config.arch}(ct={self.config.ct}) "
                f"{self.bits_a}x{self.bits_b}b [{self.substrate}]: "
                f"max column 2^{math.log2(self.max_column):.1f}, "
                f"headroom {self.headroom_bits:.1f} bits, "
                f"width {self.required_width}")


class _Ctx:
    """Violation collector tracking the worst column bound seen."""

    def __init__(self):
        self.violations = []
        self.max_seen = 1

    def note(self, bounds) -> None:
        m = max(bounds, default=0)
        if m > self.max_seen:
            self.max_seen = m

    def check(self, bounds, where: str) -> None:
        self.note(bounds)
        for k, bound in enumerate(bounds):
            if bound > U32_MAX:
                self.violations.append(Violation(
                    analyzer="intervals", rule="u32-overflow", where=where,
                    detail=f"column {k} bound {bound} = "
                           f"2^{math.log2(bound):.2f} exceeds uint32"))


# --------------------------------------------------------------- domain ops

def operand_bounds(bits: int) -> list:
    """Per-limb worst-case values of a ``bits``-bit canonical operand."""
    n = L.n_limbs_for_bits(bits)
    out = [L.MASK] * n
    rem = bits - (n - 1) * L.RADIX_BITS
    out[-1] = (1 << rem) - 1
    return out


def canonical_bounds(width: int) -> list:
    """Bounds of a normalized (post-final-adder) limb vector."""
    return [L.MASK] * width


def ppm_bounds(amax, bmax) -> list:
    """Abstract ``limbs.ppm``: column bounds of the lo/hi scatter."""
    la, lb = len(amax), len(bmax)
    cols = [0] * (la + lb)
    for i in range(la):
        for j in range(lb):
            p = amax[i] * bmax[j]
            cols[i + j] += min(p, L.MASK)           # lo half
            cols[i + j + 1] += p >> L.RADIX_BITS    # hi half
    return cols


def compress_bounds(terms, width: int, ctx: _Ctx, where: str) -> list:
    """Abstract ``limbs.compress``: shifted addition of bound vectors.

    uint32 addition of non-negative terms is monotone, so intermediate
    partial sums are dominated by the final bound -- one check covers
    the whole reduction.
    """
    acc = [0] * width
    for bounds, shift in terms:
        take = min(len(bounds), width - shift)
        for k in range(max(take, 0)):
            acc[shift + k] += bounds[k]
    ctx.check(acc, where)
    return acc


def adder_bounds(cols, out_limbs: int, ctx: _Ctx, where: str) -> list:
    """Abstract final adder (1CA and 3CA share the carry recurrence).

    Threads the worst-case carry through the column walk and checks the
    uint32 expression ``tot = col + carry`` at every position -- the
    overflow surface of final_adder_1ca/_3ca, the kernels' unrolled
    carry loops, and _kara_carry alike.  Returns canonical bounds.
    """
    carry = 0
    width = len(cols)
    for k in range(max(width, out_limbs)):
        col = cols[k] if k < width else 0
        tot = col + carry
        if tot > U32_MAX:
            ctx.violations.append(Violation(
                analyzer="intervals", rule="u32-overflow", where=where,
                detail=f"final-adder column {k}: col {col} + carry "
                       f"{carry} = {tot} exceeds uint32"))
        if tot > ctx.max_seen:
            ctx.max_seen = tot
        carry = tot >> L.RADIX_BITS
    return canonical_bounds(out_limbs)


def negate_bounds(width: int) -> tuple:
    """Abstract ``limbs.negate_cols``: (NOT columns, +1 correction)."""
    inv = [L.MASK] * width            # MASK - placed <= MASK columnwise
    one = [1] + [0] * (width - 1)
    return inv, one


# ------------------------------------------------------- architecture walks

def _fb_walk(amax, bmax, geo, adder, ctx):
    """FB dataflow (core feedback_mul == kernel _fb_kernel bounds)."""
    la, chunk = len(amax), geo.chunk
    width = la + chunk + 1
    r = [0] * width                                  # acc starts zeroed
    for t, (lo, hi) in enumerate(geo.b_windows):
        bchunk = [bmax[j] if j < len(bmax) else 0 for j in range(lo, hi)]
        shifted = r[chunk:] + [0] * chunk            # feedback >> chunk
        cols = ppm_bounds(amax, bchunk)
        acc = compress_bounds([(cols, 0), (shifted, 0)], width, ctx,
                              f"fb cycle {t} compressor")
        r = adder_bounds(acc, width, ctx, f"fb cycle {t} final adder")
    return width


def _ff_walk(amax, bmax, geo, adder, ctx):
    """FF dataflow: register file accumulation, one final-adder pass."""
    la, chunk = len(amax), geo.chunk
    width = la + geo.ct_run * chunk + 1
    terms = []
    for t, (lo, hi) in enumerate(geo.b_windows):
        bchunk = [bmax[j] if j < len(bmax) else 0 for j in range(lo, hi)]
        terms.append((ppm_bounds(amax, bchunk), t * chunk))
    acc = compress_bounds(terms, width, ctx, "ff register file")
    adder_bounds(acc, len(amax) + len(bmax), ctx, "ff final adder")
    return width


def _half_sum_bounds(x0, x1, out, ctx, where):
    """Abstract ``add_canonical(x0, x1, out)`` (the A0+A1 port sums)."""
    width = max(len(x0), len(x1)) + 1
    acc = compress_bounds([(x0, 0), (x1, 0)], width, ctx, where)
    return adder_bounds(acc, out, ctx, where)


def _kara_ppm_walk(amax, bmax, levels, ctx, depth=0):
    """Abstract ``karatsuba.karatsuba_ppm`` recursion -> column bounds."""
    la, lb = len(amax), len(bmax)
    if levels == 0 or la <= 1 or lb <= 1:
        cols = ppm_bounds(amax, bmax)
        ctx.check(cols, f"karatsuba L{depth} schoolbook PPM")
        return cols
    n = max(la, lb)
    n += n % 2
    half = n // 2
    pad = lambda x: x + [0] * (n - len(x))
    a0, a1 = pad(amax)[:half], pad(amax)[half:]
    b0, b1 = pad(bmax)[:half], pad(bmax)[half:]
    w = f"karatsuba L{depth}"
    sa = _half_sum_bounds(a0, a1, half + 1, ctx, f"{w} A0+A1")
    sb = _half_sum_bounds(b0, b1, half + 1, ctx, f"{w} B0+B1")
    width = la + lb
    t0 = adder_bounds(_kara_ppm_walk(a0, b0, levels - 1, ctx, depth + 1),
                      2 * half, ctx, f"{w} T0 normalize")
    t1 = adder_bounds(_kara_ppm_walk(a1, b1, levels - 1, ctx, depth + 1),
                      2 * half, ctx, f"{w} T1 normalize")
    t2 = adder_bounds(_kara_ppm_walk(sa, sb, levels - 1, ctx, depth + 1),
                      2 * half + 2, ctx, f"{w} T2 normalize")
    neg0, one0 = negate_bounds(width)
    neg1, one1 = negate_bounds(width)
    return compress_bounds(
        [(t0, 0), (t1, 2 * half), (t2, half),
         (neg0, 0), (one0, 0), (neg1, 0), (one1, 0)],
        width, ctx, f"{w} combine compressor")


def _kara_core_walk(amax, bmax, levels, adder, ctx):
    """Core ``karatsuba_mul``: CT=3 scan + compressor feedback."""
    la, lb = len(amax), len(bmax)
    n = max(la, lb)
    n += n % 2
    half = n // 2
    pad = lambda x: x + [0] * (n - len(x))
    a0, a1 = pad(amax)[:half], pad(amax)[half:]
    b0, b1 = pad(bmax)[:half], pad(bmax)[half:]
    sa = _half_sum_bounds(a0, a1, half + 1, ctx, "kara top A0+A1")
    sb = _half_sum_bounds(b0, b1, half + 1, ctx, "kara top B0+B1")
    width = la + lb
    acc = [0] * width
    pairs = ((a0, b0, "T0"), (a1, b1, "T1"), (sa, sb, "T2"))
    for av, bv, name in pairs:
        cols = _kara_ppm_walk(list(av), list(bv), levels - 1, ctx)
        t = adder_bounds(cols, 2 * half + 2, ctx, f"kara top {name}")
        neg, one = negate_bounds(width)
        if name == "T2":
            contrib = compress_bounds([(t, half)], width, ctx,
                                      f"kara top place {name}")
        else:
            shift = 0 if name == "T0" else 2 * half
            contrib = compress_bounds([(t, shift), (neg, 0), (one, 0)],
                                      width, ctx, f"kara top place {name}")
        acc = [x + y for x, y in zip(acc, contrib)]
        ctx.check(acc, f"kara top feedback after {name}")
    adder_bounds(acc, width, ctx, "kara top final adder")
    return width


def _kara_kernel_walk(amax, bmax, ctx):
    """The reference's TPU ``_kara_kernel``: scratch accumulator +
    NOT+1 columns (kept, so the port's violations equal the reference's)."""
    la, lb = len(amax), len(bmax)
    geo = fold_geometry(la, lb, 3, "karatsuba")
    width = geo.scratch_width                        # 2 * n
    n = width // 2
    half = n // 2
    hp = half + 1
    pad = lambda x: x + [0] * (n - len(x))
    a0, a1 = pad(amax)[:half], pad(amax)[half:]
    b0, b1 = pad(bmax)[:half], pad(bmax)[half:]
    # _kara_carry(a0 + a1, hp): raw column sums then carry walk
    sums_a = [x + y for x, y in zip(a0, a1)]
    sums_b = [x + y for x, y in zip(b0, b1)]
    ctx.check(sums_a, "kara kernel A0+A1 columns")
    ctx.check(sums_b, "kara kernel B0+B1 columns")
    adder_bounds(sums_a, hp, ctx, "kara kernel A0+A1 carry")
    adder_bounds(sums_b, hp, ctx, "kara kernel B0+B1 carry")
    # worst cycle operands: canonical hp-limb ports (covers a0p/a1p/sa)
    port = canonical_bounds(hp)
    cols = ppm_bounds(port, port)[:2 * hp]
    ctx.check(cols, "kara kernel shared PPM")
    t = adder_bounds(cols, 2 * hp, ctx, "kara kernel T normalize")

    def place(shift):
        take = min(2 * hp, width - shift)
        return [0] * shift + t[:take] + [0] * (width - shift - take)

    def neg_place():
        out = [L.MASK] * width
        out[0] += 1                                  # the +1 correction
        return out

    acc = [x + y for x, y in zip(place(0), neg_place())]          # j=0
    ctx.check(acc, "kara kernel feedback j=0")
    acc = [x + y + z for x, y, z in zip(acc, place(2 * half),
                                        neg_place())]             # j=1
    ctx.check(acc, "kara kernel feedback j=1")
    acc = [x + y for x, y in zip(acc, place(half))]               # j=2
    ctx.check(acc, "kara kernel feedback j=2")
    adder_bounds(acc, la + lb, ctx, "kara kernel final carry")
    return width


def _star_walk(amax, bmax, adder, ctx):
    cols = ppm_bounds(amax, bmax)
    ctx.check(cols, "star PPM")
    adder_bounds(cols, len(amax) + len(bmax), ctx, "star final adder")
    return len(amax) + len(bmax)


def _fused_walk(amax, bmax, cfg, ctx):
    """Fused bank megakernel dataflow (``kernels.bank_fold``).

    Every arch runs the same windowed-schoolbook datapath there: grid
    step t masks B to its ``fused_windows`` limb range, the masked PPM
    columns land at absolute positions in the full-width carry-save
    accumulator (no per-step shift), and one final carry pass retires
    the product on the last step.  Idle padded steps have empty windows
    and contribute exactly zero, so checking the real windows covers
    the padded super-geometry row.
    """
    la, lb = len(amax), len(bmax)
    width = la + lb
    acc = [0] * width
    for t, (lo, hi) in enumerate(fused_windows(cfg, la, lb)):
        bm = [bmax[j] if lo <= j < hi else 0 for j in range(lb)]
        cols = ppm_bounds(amax, bm)
        acc = [x + y for x, y in zip(acc, cols)]
        ctx.check(acc, f"fused step {t} accumulator")
    adder_bounds(acc, width, ctx, "fused final carry")
    return width


def _signed_walk(la, lb, ctx):
    """The _signed_mul correction pass on top of the unsigned product."""
    width = la + lb
    prod = canonical_bounds(width)
    nb, ob = negate_bounds(width)
    na, oa = negate_bounds(width)
    acc = compress_bounds([(prod, 0), (nb, 0), (ob, 0), (na, 0), (oa, 0)],
                          width, ctx, "signed correction compressor")
    adder_bounds(acc, width, ctx, "signed correction final adder")


# ----------------------------------------------------------------- analyze

def analyze(bits_a: int, bits_b: int, cfg: MCIMConfig,
            substrate: str = "core") -> IntervalReport:
    """Prove (or refute) overflow-safety of one design on one substrate.

    Walks the exact dataflow ``mcim_mul`` (substrate="core"), the
    reference's ``mcim_fold`` TPU kernels (substrate="kernel") or the
    ``bank_fold`` kernel (substrate="fused") execute for a
    ``bits_a x bits_b`` multiply under ``cfg``, propagating worst-case
    per-column magnitudes.  ``required_width`` is the accumulator width
    the walk needed -- the figure the scratch contract checks against.
    """
    if substrate not in SUBSTRATES:
        raise ValueError(f"substrate must be one of {SUBSTRATES}")
    amax = operand_bounds(bits_a)
    bmax = operand_bounds(bits_b)
    la, lb = len(amax), len(bmax)
    ctx = _Ctx()
    if substrate == "fused":
        required = _fused_walk(amax, bmax, cfg, ctx)
    elif cfg.arch == "star":
        required = _star_walk(amax, bmax, cfg.adder, ctx)
    elif cfg.arch == "fb":
        geo = fold_geometry(la, lb, cfg.ct, "fb")
        required = _fb_walk(amax, bmax, geo, cfg.adder, ctx)
    elif cfg.arch == "ff":
        geo = fold_geometry(la, lb, cfg.ct, "ff")
        required = _ff_walk(amax, bmax, geo, cfg.adder, ctx)
    elif cfg.arch == "karatsuba":
        if substrate == "kernel":
            # the kernel realizes Karat-1 regardless of cfg.levels
            required = _kara_kernel_walk(amax, bmax, ctx)
        else:
            required = _kara_core_walk(amax, bmax, cfg.levels, cfg.adder,
                                       ctx)
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    if cfg.signed:
        _signed_walk(la, lb, ctx)
    headroom = 32.0 - math.log2(max(ctx.max_seen, 1))
    return IntervalReport(
        bits_a=bits_a, bits_b=bits_b, config=cfg, substrate=substrate,
        ok=not ctx.violations, max_column=ctx.max_seen,
        headroom_bits=round(headroom, 3), required_width=required,
        violations=tuple(ctx.violations))


def required_scratch_width(bits_a: int, bits_b: int, cfg: MCIMConfig,
                           substrate: str = "kernel") -> int:
    """Accumulator width the interval walk proves the design needs."""
    return analyze(bits_a, bits_b, cfg, substrate).required_width



# ------------------------------------------------------- the CUDA row tiles

def row_tile_weights(cfg: MCIMConfig, la: int, lb: int,
                     substrate: str) -> list:
    """Per-B-limb weights the CUDA ``tiles::schoolbook`` multiplies by.

    ``fused`` (``bank_fold``): how many of the instance's fused windows
    hold the limb.  ``kernel`` (FB, FF and star on the fold kernels): 1
    on every limb, since ``ct_run * chunk >= LB``.
    """
    if substrate == "fused":
        wins = fused_windows(cfg, la, lb)
        return [sum(1 for lo, hi in wins if lo <= jb < hi)
                for jb in range(lb)]
    if substrate == "kernel" and cfg.arch in ("star", "fb", "ff"):
        return [1] * lb
    raise ValueError(f"no row-tile schoolbook for {cfg.arch} on "
                     f"{substrate!r} (the Karatsuba kernels run KaraRows)")


def analyze_row_tiles(bits_a: int, bits_b: int, cfg: MCIMConfig,
                      substrate: str = "fused") -> IntervalReport:
    """The uint32 columns of the port's row-tile CUDA kernels.

    Walks ``tiles::ppm_weighted`` (``csrc/row_tiles.cuh``): B limb
    ``jb`` adds ``w[jb] * lo`` and ``w[jb] * hi`` halves at their
    absolute columns, the weights from :func:`row_tile_weights`; then
    ``carry_pass`` over the LA+LB product columns.  All terms are
    non-negative, so the kernel's order of addition never exceeds the
    final bound.  Signed designs add the bank-wide correction pass.
    """
    amax = operand_bounds(bits_a)
    bmax = operand_bounds(bits_b)
    la, lb = len(amax), len(bmax)
    weights = row_tile_weights(cfg, la, lb, substrate)
    ctx = _Ctx()
    cols = [0] * (la + lb)
    for jb, w in enumerate(weights):
        for i in range(la):
            p = amax[i] * bmax[jb]
            cols[i + jb] += w * min(p, L.MASK)
            cols[i + jb + 1] += w * (p >> L.RADIX_BITS)
    ctx.check(cols, f"row tiles {substrate} schoolbook")
    adder_bounds(cols, la + lb, ctx, f"row tiles {substrate} carry pass")
    if cfg.signed:
        _signed_walk(la, lb, ctx)
    headroom = 32.0 - math.log2(max(ctx.max_seen, 1))
    return IntervalReport(
        bits_a=bits_a, bits_b=bits_b, config=cfg, substrate=substrate,
        ok=not ctx.violations, max_column=ctx.max_seen,
        headroom_bits=round(headroom, 3), required_width=la + lb,
        violations=tuple(ctx.violations))
