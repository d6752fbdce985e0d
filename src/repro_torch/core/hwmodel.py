"""Analytical 40nm energy/area model of the DS-CIM macro (Table III, Fig.
4/7): port of ``repro/core/hwmodel.py`` (plain Python, no framework).

The paper's TOPS/W and TOPS/mm2 are post-layout silicon numbers; the model
reproduces them from per-cycle component energies (SNGs, OR gates,
adders, accumulators, SRAM and PRNG overheads) calibrated to the paper's
headline numbers, then extrapolates across the compute/memory ratio and
the bitstream length (Fig. 4) and gives the power and area breakdown
(Fig. 7).  These are the silicon macro's numbers, not the GPU's.

Conventions (Table III footnotes):
* "ops" are 1b-equivalent: one 8b x 8b MAC = 2 * 64 = 128 ops;
* efficiency at the macro level (SRAM + SNG + MAC + accumulator), 40nm.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MacroGeometry", "EnergyParams", "AreaParams", "HWModel",
           "DSCIM1_HW", "DSCIM2_HW"]

OPS_PER_MAC_1B = 128.0  # 8b x 8b MAC in 1b-op units (Table III footnote 1)


@dataclasses.dataclass(frozen=True)
class MacroGeometry:
    rows: int = 128          # SRAM rows (accumulation window) per column
    cols: int = 32           # weight columns
    cmr: int = 64            # OR-MAC replicas per column (compute/memory)
    group: int = 16          # rows per OR gate (16 -> DS-CIM1, 64 -> DS-CIM2)
    length: int = 256        # bitstream length L
    latch_cached: bool = False  # DS-CIM2's latch-cached accumulator
    freq_ghz: float = 1.0    # post-layout clock (OR-MAC64 path is 0.4 ns)

    @property
    def n_or(self) -> int:
        return self.rows // self.group

    @property
    def adder_width(self) -> int:
        return max(1, (self.n_or - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """Per-event energies in fJ (40nm, ~0.7-0.9V), calibrated to Table III:
    the paper's TOPS/W scale exactly as 1/L at a fixed variant, which pins
    the per-cycle macro energy to 195.7 pJ (DS-CIM1) / 147 pJ (DS-CIM2
    with the latch); the components split as Fig. 7 shows (accumulator
    ~40% before the latch, SNGs dominant, OR and adder cheap)."""
    sng: float = 4.61        # one 8b comparator toggle (SNG), per cycle
    or_in: float = 0.0597    # OR tree, per input bit per cycle
    add_bit: float = 0.478   # per adder output bit per cycle
    acc_bit: float = 1.91    # accumulator register+add, per bit per cycle
    latch_bit: float = 0.6   # D-latch cache write, per bit per cycle
    sram_row: float = 130.0  # one row read (amortized over SC window)
    prng_cycle: float = 3000.0  # shared 8b PRNG pair, per cycle (whole macro)
    acc_width: int = 20      # accumulator width (L<=256, <=8 groups)

    def sparsity_factor(self, signed: bool) -> float:
        """Signed ops map data to [0,255] -> denser bitstreams -> more toggles.
        Paper Fig. 7: signed mode costs noticeably more in DS-CIM1."""
        return 1.0 if not signed else 1.45


@dataclasses.dataclass(frozen=True)
class AreaParams:
    """Block areas in um^2, calibrated jointly to: the 0.78/0.72 mm^2 macro
    totals, the Table-III TOPS/mm^2 set, AND Fig. 4's "64x throughput at
    ~2x area" CMR claim (which pins the non-replicated SRAM+weight-SNG base
    at ~half the macro).  sram_cell is the *effective* per-bit area incl.
    wordline/bitline periphery share."""
    sram_cell: float = 6.8       # 6T cell + periphery share, per bit
    sng: float = 9.0             # 8b SNG comparator
    or_in: float = 0.2           # OR tree per input
    add_bit: float = 10.0        # adder per output bit (fast custom cell [28])
    acc_bit: float = 2.0         # accumulator per bit
    latch_bit: float = 0.5       # D-latch per bit
    prng: float = 2600.0         # two shared 8b PRNGs + distribution
    overhead: float = 1.455      # routing/ctrl/pipeline fill factor


class HWModel:
    """Analytical throughput/energy/area for one DS-CIM macro."""

    def __init__(self, geo: MacroGeometry,
                 ep: EnergyParams | None = None,
                 ap: AreaParams | None = None):
        self.geo = geo
        self.ep = ep or EnergyParams()
        self.ap = ap or AreaParams()

    # -- throughput -----------------------------------------------------------
    def macs_per_cycle(self) -> float:
        g = self.geo
        return g.rows * g.cols * g.cmr / g.length

    def tops_1b(self) -> float:
        return (self.macs_per_cycle() * OPS_PER_MAC_1B * self.geo.freq_ghz
                * 1e9 / 1e12)

    # -- energy ---------------------------------------------------------------
    def energy_per_cycle_fj(self, signed: bool = True) -> dict:
        g, ep = self.geo, self.ep
        sf = ep.sparsity_factor(signed)
        # weight SNGs: one per row per column; activation SNGs: one per row,
        # shared across the 32 columns (broadcast).
        e_sng_w = g.rows * g.cols * ep.sng * sf
        e_sng_a = g.rows * g.cmr * ep.sng * sf
        e_or = g.rows * g.cols * g.cmr * ep.or_in * sf
        e_add = g.adder_width * g.cols * g.cmr * ep.add_bit
        if g.latch_cached:
            e_acc = (g.cols * g.cmr *
                     (4 * g.adder_width * ep.latch_bit          # latch fills
                      + ep.acc_width * ep.acc_bit / 4.0))       # 1-in-4 accum
        else:
            e_acc = g.cols * g.cmr * ep.acc_width * ep.acc_bit
        # SRAM: weights are stationary during the SC window; one row refresh
        # per L cycles (pipelined channel loading, Fig. 5).
        e_sram = g.rows * g.cols * ep.sram_row / g.length
        e_prng = ep.prng_cycle
        return {"sng": e_sng_w + e_sng_a, "or": e_or, "adder": e_add,
                "accum": e_acc, "sram": e_sram, "prng": e_prng}

    def tops_per_watt(self, signed: bool = True) -> float:
        e = sum(self.energy_per_cycle_fj(signed).values())  # fJ / cycle
        ops = self.macs_per_cycle() * OPS_PER_MAC_1B        # ops / cycle
        return ops / (e * 1e-15) / 1e12                     # ops/J -> TOPS/W

    # -- area -----------------------------------------------------------------
    def area_um2(self) -> dict:
        g, ap = self.geo, self.ap
        a_sram = g.rows * g.cols * 8 * ap.sram_cell
        a_sng = (g.rows * g.cols + g.rows * g.cmr) * ap.sng
        a_or = g.rows * g.cols * g.cmr * ap.or_in
        a_add = g.adder_width * g.cols * g.cmr * ap.add_bit
        acc_unit = self.ep.acc_width * ap.acc_bit
        if g.latch_cached:
            acc_unit += 4 * g.adder_width * ap.latch_bit
        a_acc = g.cols * g.cmr * acc_unit
        a_prng = ap.prng
        return {"sram": a_sram, "sng": a_sng, "or": a_or, "adder": a_add,
                "accum": a_acc, "prng": a_prng}

    def area_mm2(self) -> float:
        return sum(self.area_um2().values()) * self.ap.overhead / 1e6

    def tops_per_mm2(self) -> float:
        return self.tops_1b() / self.area_mm2()

    def summary(self, signed: bool = True) -> dict:
        e = self.energy_per_cycle_fj(signed)
        a = self.area_um2()
        return {
            "tops_1b": self.tops_1b(),
            "tops_per_watt": self.tops_per_watt(signed),
            "area_mm2": self.area_mm2(),
            "tops_per_mm2": self.tops_per_mm2(),
            "power_breakdown": {k: v / sum(e.values()) for k, v in e.items()},
            "area_breakdown": {k: v / sum(a.values()) for k, v in a.items()},
            "latency_us_per_mvm": self.geo.length / (self.geo.freq_ghz * 1e3),
        }


def DSCIM1_HW(length: int = 256, cmr: int = 64,
              freq_ghz: float = 0.697) -> HWModel:
    """Precise variant: 8x OR-MAC16 / column (post-layout corner 0.7 GHz)."""
    return HWModel(MacroGeometry(group=16, length=length, cmr=cmr,
                                 latch_cached=False, freq_ghz=freq_ghz))


def DSCIM2_HW(length: int = 64, cmr: int = 64,
              freq_ghz: float = 0.4995) -> HWModel:
    """Efficient variant: 2x OR-MAC64 / column + latch-cached accumulator."""
    return HWModel(MacroGeometry(group=64, length=length, cmr=cmr,
                                 latch_cached=True, freq_ghz=freq_ghz))
