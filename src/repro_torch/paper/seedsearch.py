"""Sec. IV-C: the PRNG-type x seed search (a small grid by default;
``--wide`` runs the full calibration grid).  The count LUT is a function
of the point sequence alone, so the search is host arithmetic in numpy
(``core/seed_search.py search``), as the reference's.

  PYTHONPATH=src python -m repro_torch.paper seedsearch [--wide]
"""
from __future__ import annotations

import sys

from ..core.seed_search import search
from ..device import resolve_device

__all__ = ["run", "main"]


def run(wide: bool = False, device=None):
    """The best point configuration per (variant, L), with its runner-up.
    The search runs on the host; ``device`` is resolved as every
    section's (CUDA unless the CPU is asked for), so a run that wanted
    the card fails without one."""
    resolve_device(device)
    rows = []
    seeds = (1, 7, 23, 51, 91, 151, 199, 233) if wide else (1, 91, 233)
    params = (0, 1) if wide else (0,)
    for variant, k in (("dscim1", 2), ("dscim2", 3)):
        for L in ((64, 128, 256) if wide else (64, 256)):
            best = search(k, L, trunc="floor",
                          kinds=("lfsr", "galois", "lcg"),
                          seeds=seeds, params=params,
                          n_vec=24, n_cols=128, top=3)
            b = best[0]
            rows.append({
                "name": f"seedsearch/{variant}/L{L}",
                "best": f"{b.kind}(su={b.seed_u},sv={b.seed_v})",
                "rmse": b.rmse_unsigned,
                "second": best[1].rmse_unsigned,
            })
    return rows


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    rows = run("--wide" in argv, device)
    for r in rows:
        print(f"{r['name']},0,best={r['best']};rmse={r['rmse']:.3f}%;"
              f"runnerup={r['second']:.3f}%")
    return rows
