"""Table III + Fig. 4 + Fig. 7: hardware efficiency from the calibrated
analytical 40nm model (``core/hwmodel.py``).  These are the silicon
macro's model numbers reproducing the paper's post-layout results, not
GPU figures.

  PYTHONPATH=src python -m repro_torch.paper t3_efficiency
"""
from __future__ import annotations

from ..core.hwmodel import DSCIM1_HW, DSCIM2_HW
from ..device import resolve_device

__all__ = ["PAPER", "run", "main"]

# the paper's Table III: (TOPS/W, TOPS/mm2)
PAPER = {
    ("dscim1", 256): (669.7, 117.1), ("dscim1", 64): (2677.2, 468.4),
    ("dscim2", 64): (3566.1, 363.7), ("dscim2", 256): (891.5, 90.9),
}


def run(device=None):
    """The rows of Table III (both variants at L = 64, 128, 256) and Fig.
    4's compute/memory-ratio sweep.  Host arithmetic only; ``device`` is
    resolved as every section's (CUDA unless the CPU is asked for), so
    a run that wanted the card fails without one."""
    resolve_device(device)
    rows = []
    for variant, mk in (("dscim1", DSCIM1_HW), ("dscim2", DSCIM2_HW)):
        for L in (64, 128, 256):
            s = mk(L).summary(signed=True)
            rows.append({
                "name": f"t3/{variant}/L{L}",
                "tops_w": s["tops_per_watt"],
                "tops_mm2": s["tops_per_mm2"],
                "area_mm2": s["area_mm2"],
                "paper": PAPER.get((variant, L)),
                "pwr_breakdown": s["power_breakdown"],
            })
    # Fig. 4: CMR sweep
    for cmr in (1, 4, 16, 64):
        hw = DSCIM2_HW(64, cmr=cmr)
        rows.append({
            "name": f"fig4/cmr{cmr}",
            "tops_w": hw.tops_per_watt(),
            "tops_mm2": hw.tops_per_mm2(),
            "area_mm2": hw.area_mm2(),
            "paper": None,
            "pwr_breakdown": None,
        })
    return rows


def main(device=None):
    rows = run(device)
    for r in rows:
        extra = ""
        if r["paper"]:
            extra = f";paper={r['paper'][0]}/{r['paper'][1]}"
        if r["pwr_breakdown"]:
            top = sorted(r["pwr_breakdown"].items(),
                         key=lambda kv: -kv[1])[:3]
            extra += ";pwr=" + "+".join(f"{k}:{v:.0%}" for k, v in top)
        print(f"{r['name']},0,TOPS/W={r['tops_w']:.1f};"
              f"TOPS/mm2={r['tops_mm2']:.1f};area={r['area_mm2']:.3f}mm2"
              + extra)
    return rows
