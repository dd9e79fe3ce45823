"""Switching-energy / peak-power cost model for MCIM designs (bit-level).

The paper's headline claims beyond area are **up to 33% energy savings
and 65% average peak power reduction** for TP=1/2 MCIM designs vs the
directly synthesized ``*`` operator.  We cannot measure silicon power
here, so the reproduction models energy the way the area model models
area: by counting, at BIT granularity, the work each stage performs per
multiplication, with physically-motivated activity ratios and ONE
silicon scale calibrated on a single anchor.

Per-op dynamic energy is a *counting* model -- every quantity below is
per multiplication, not per cycle, which makes the folding benefit
explicit:

  PPM         : all Na*Nb partial-product bits are generated and
                carry-save-added exactly once whatever the folding;
                what folding changes is the GLITCH factor.  Spurious
                transitions grow with the uninterrupted combinational
                depth d (carry-save rows traversed before a register
                boundary): Star propagates through all Nb rows, a
                folded design only through Nb/CT rows per pass
                (registers kill glitch propagation).  We model the
                multiplier as glitch(d) = 1 + G_GLITCH * d**GLITCH_EXP
                (sub-linear: array glitching saturates with depth).
  compressor  : reducing Na*Nb PP bits to 2 carry-save rows costs
                (Na*Nb - 2W) full-adder compressions *regardless* of
                architecture (each FA retires one bit) -- same count
                for Star's internal CSA and a folded design's external
                rows -- but it glitches at the same depth as the PPM.
  final adder : every product bit exits through a carry-propagate
                adder exactly once; longer adders glitch more
                (1 + G_ADDER * log2(width)), so Star's full-width CPA
                pays more per bit than FB's Na+Nb/CT+1 adder, and a
                3CA splits the add into 3 shorter, cheaper passes.
  registers   : folded designs clock flip-flops (retired product bits,
                FF's carry-save pairs, Karatsuba's accumulator); Star
                is purely combinational.  Flip-flop energy is dominated
                by the clock pin (A_REG well below logic activity).
  leakage     : proportional to instantiated area (area_model cells) --
                folded designs leak less because they ARE smaller.

Peak power is the largest per-cycle switched capacitance times the
clock frequency: Star switches its entire dynamic energy in ONE cycle,
a folded design spreads it over CT cycles, so peak power drops by
roughly the energy ratio divided by CT -- reproducing the paper's
"65% average peak power reduction" headline direction.

The single silicon scale is calibrated on ONE anchor -- Star 16x16 =
1.0 pJ/op, the 45 nm integer-multiply energy scale of Horowitz's
ISSCC'14 survey -- exactly as ``area_model`` anchors on Star 16x16 =
1348 um^2.  Every other energy/power figure in benchmarks/ is a model
prediction; ``benchmarks.paper_tables.table_energy`` reports the sweep
vs the paper's headline direction.
"""
from __future__ import annotations

import dataclasses
from math import ceil, log2

from .mcim import MCIMConfig
from . import area_model
from . import timing_model

# ------------------------------------------------------------- model knobs
# Activity ratios (fraction of cells that toggle per op), physically
# motivated: random operands toggle ~half the AND/CSA cells; external
# compression re-walks already-partially-settled sums; adder cells are
# larger (RHO_ADD) but settle once; flip-flop energy is mostly clock pin.
A_PPM = 0.5
A_COMP = 0.25
A_ADD = 0.15
A_REG = 0.08

#: glitch factor 1 + G_GLITCH * depth**GLITCH_EXP for a combinational
#: block of carry-save depth ``depth`` (rows before a register boundary)
G_GLITCH = 0.28
GLITCH_EXP = 0.65
#: final-adder glitch slope per log2 of adder length
G_ADDER = 0.12
#: leakage energy per op as a fraction of instantiated area cells
LEAK_RATIO = 0.08
#: extra compress+add pass for the two's-complement sign correction
SIGNED_OVERHEAD = 1.05

#: bump when the model maths change -- keyed into the autotuner's
#: score cache so stale fronts are never served across model revisions
MODEL_VERSION = "power-1"


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Per-op energy by stage, in calibrated cell units."""
    ppm: float
    compressor: float
    final_adder: float
    registers: float
    leakage: float

    @property
    def dynamic(self) -> float:
        return self.ppm + self.compressor + self.final_adder + self.registers

    @property
    def total(self) -> float:
        return self.dynamic + self.leakage


def _glitch(depth: float) -> float:
    return 1.0 + G_GLITCH * max(depth, 1.0) ** GLITCH_EXP

def _adder_glitch(width: float, fold: int = 1) -> float:
    return 1.0 + G_ADDER * log2(max(width / fold, 2.0))

def _fa_count(na: int, nb: int, width: int) -> float:
    """Full-adder compressions to reduce na*nb PP bits to 2 rows."""
    return float(max(na * nb - 2 * width, 0))


# -------------------------------------------------------------- per design

def star_energy(na: int, nb: int) -> EnergyBreakdown:
    """Single-cycle '*': full-depth glitch, full-width CPA, no registers."""
    width = na + nb
    return EnergyBreakdown(
        ppm=A_PPM * na * nb * _glitch(nb),
        compressor=A_COMP * _fa_count(na, nb, width) * _glitch(nb),
        final_adder=A_ADD * area_model.RHO_ADD * width * _adder_glitch(width),
        registers=0.0,
        leakage=LEAK_RATIO * area_model.star_units(na, nb).total,
    )


def fb_energy(na: int, nb: int, ct: int) -> EnergyBreakdown:
    """Feedback: Nb/CT rows per pass (average occupied depth -- the last
    pass is partially filled), short Na+Nb/CT+1 adder, retired-bit regs."""
    depth = nb / ct
    chunk = ceil(nb / ct)
    w_add = na + chunk + 1
    return EnergyBreakdown(
        ppm=A_PPM * na * nb * _glitch(depth),
        compressor=A_COMP * _fa_count(na, nb, na + nb) * _glitch(depth),
        final_adder=A_ADD * area_model.RHO_ADD * (na + nb)
                    * _adder_glitch(w_add),
        registers=A_REG * area_model.RHO_REG * (nb - chunk),
        leakage=LEAK_RATIO * area_model.fb_units(na, nb, ct).total,
    )


def ff_energy(na: int, nb: int, ct: int, adder: str = "1ca") -> EnergyBreakdown:
    """Feed-forward: same folded-depth glitch, but every carry-save pair
    is registered (CT pairs written once each) and the final add is
    full-width (split into 3 shorter passes by a 3CA)."""
    depth = nb / ct
    chunk = ceil(nb / ct)
    width = na + nb
    fold = 3 if adder == "3ca" else 1
    return EnergyBreakdown(
        ppm=A_PPM * na * nb * _glitch(depth),
        compressor=A_COMP * _fa_count(na, nb, width) * _glitch(depth),
        final_adder=A_ADD * area_model.RHO_ADD * width
                    * _adder_glitch(width, fold),
        registers=A_REG * area_model.RHO_REG * ct * (na + chunk),
        leakage=LEAK_RATIO * area_model.ff_units(na, nb, ct, adder).total,
    )


def karatsuba_energy(na: int, nb: int, levels: int,
                     adder: str = "1ca") -> EnergyBreakdown:
    """CT=3 folded Karatsuba: 3 passes over one shared (n/2+1)-port PPM
    (3^levels leaf multiplies in total) -- fewer PP bits than Star's n^2
    and a shallower leaf array, at the cost of accumulator registers."""
    n = max(na, nb)
    width = na + nb
    ppm_cells, comb_cells = area_model._kara_ppm_units(n // 2 + 1, levels - 1)
    leaf = n // 2 + 1
    for _ in range(levels - 1):
        leaf = leaf // 2 + 1
    bits = 3 * (ppm_cells + comb_cells)     # PP bits + combine compressions
    fold = 3 if adder == "3ca" else 1
    return EnergyBreakdown(
        ppm=A_PPM * 3 * ppm_cells * _glitch(leaf),
        compressor=A_COMP * (3 * comb_cells + max(bits - 2 * width, 0.0))
                   * _glitch(leaf) / 2.0,
        final_adder=A_ADD * area_model.RHO_ADD * width
                    * _adder_glitch(width, fold),
        registers=A_REG * area_model.RHO_REG * 3 * width,
        leakage=LEAK_RATIO
                * area_model.karatsuba_units(na, nb, levels, adder).total,
    )


def mcim_energy(bits_a: int, bits_b: int, cfg: MCIMConfig) -> EnergyBreakdown:
    """Per-op energy breakdown for one MCIM instance (cell units)."""
    if cfg.arch == "star":
        e = star_energy(bits_a, bits_b)
    elif cfg.arch == "fb":
        e = fb_energy(bits_a, bits_b, cfg.ct)
    elif cfg.arch == "ff":
        e = ff_energy(bits_a, bits_b, cfg.ct, cfg.adder)
    else:
        e = karatsuba_energy(bits_a, bits_b, cfg.levels, cfg.adder)
    if cfg.signed:
        # one extra negate+compress+add pass for the sign corrections
        e = EnergyBreakdown(
            ppm=e.ppm,
            compressor=e.compressor * SIGNED_OVERHEAD,
            final_adder=e.final_adder * SIGNED_OVERHEAD,
            registers=e.registers,
            leakage=e.leakage,
        )
    return e


def peak_switched(bits_a: int, bits_b: int, cfg: MCIMConfig) -> float:
    """Largest per-cycle switched capacitance (cell units).

    Star commits its whole dynamic energy in a single cycle.  FB and
    Karatsuba spread theirs ~uniformly over CT cycles.  FF's fold cycles
    carry the PPM/compressor/register work while the full-width final
    add lands in the retire cycle, which is therefore its peak.
    """
    e = mcim_energy(bits_a, bits_b, cfg)
    if cfg.arch == "star":
        return e.dynamic
    if cfg.arch == "ff":
        per_fold = (e.ppm + e.compressor + e.registers) / cfg.ct
        return per_fold + e.final_adder
    return e.dynamic / cfg.ct


# ------------------------------------------------------------- calibration
# ONE anchor, exactly as area_model: Star 16x16 = 1.0 pJ per multiply
# (the 45 nm integer-multiply scale of Horowitz, ISSCC 2014).
FJ_PER_CELL = 1000.0 / star_energy(16, 16).total


def energy_per_op_pj(bits_a: int, bits_b: int, cfg: MCIMConfig) -> float:
    """Modeled energy per multiplication, picojoules."""
    return mcim_energy(bits_a, bits_b, cfg).total * FJ_PER_CELL / 1000.0


def peak_power_mw(bits_a: int, bits_b: int, cfg: MCIMConfig,
                  clock_ns: float | None = None) -> float:
    """Peak power (mW) = max per-cycle switched energy / clock period.

    ``clock_ns`` defaults to the design's own combinational path (its
    natural clock); pass a common clock to compare designs in a bank.
    """
    period = clock_ns if clock_ns is not None \
        else timing_model.t_comb(cfg.arch, max(bits_a, bits_b))
    sw_fj = peak_switched(bits_a, bits_b, cfg) * FJ_PER_CELL
    return sw_fj / period * 1e-3          # fJ/ns = uW


# ----------------------------------------------------------- vs-Star views

def energy_savings_vs_star(bits_a: int, bits_b: int, cfg: MCIMConfig) -> float:
    """Fractional per-op energy savings vs the single-cycle Star."""
    star = star_energy(bits_a, bits_b).total
    ours = mcim_energy(bits_a, bits_b, cfg).total
    return 1.0 - ours / star


def peak_power_reduction_vs_star(bits_a: int, bits_b: int,
                                 cfg: MCIMConfig) -> float:
    """Fractional peak-power reduction vs Star at a common clock (the
    clock cancels: this is the switched-capacitance ratio)."""
    star = peak_switched(bits_a, bits_b,
                         MCIMConfig(arch="star", ct=1,
                                    signed=cfg.signed))
    ours = peak_switched(bits_a, bits_b, cfg)
    return 1.0 - ours / star


# ------------------------------------------------------------- bank (plan)

def plan_energy_per_op_pj(bits_a: int, bits_b: int, configs,
                          stress: float = 1.0) -> float:
    """Throughput-weighted energy per multiplication of a bank.

    ``configs`` is an iterable of (count, MCIMConfig).  An instance with
    cycle time CT contributes count/CT of the bank's ops per cycle, so
    the average op costs sum(count/ct * E_op) / sum(count/ct).  The
    synthesis-stress multiplier models the larger (higher-capacitance)
    cells a tight clock target forces, mirroring CompiledDesign.area.
    """
    num = den = 0.0
    for count, cfg in configs:
        share = count / cfg.ct
        num += share * energy_per_op_pj(bits_a, bits_b, cfg)
        den += share
    return stress * num / den if den else 0.0


def plan_peak_power_mw(bits_a: int, bits_b: int, configs,
                       clock_ns: float | None = None,
                       stress: float = 1.0) -> float:
    """Bank peak power (mW): all instances switch concurrently in the
    worst cycle; the period defaults to the slowest instance's path."""
    if clock_ns is None:
        clock_ns = max(timing_model.t_comb(cfg.arch, max(bits_a, bits_b))
                       for _, cfg in configs)
    sw_fj = sum(count * peak_switched(bits_a, bits_b, cfg)
                for count, cfg in configs) * FJ_PER_CELL
    return stress * sw_fj / clock_ns * 1e-3
