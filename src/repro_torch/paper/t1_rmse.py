"""Table I (RMSE rows): DS-CIM1/2 x L in {64, 128, 256}, paper-faithful
(searched classic PRNGs, floor truncation) and beyond-paper (scrambled
low-discrepancy points + midpoint correction), beside the paper's numbers.

The counts come from the count kernel (``DSCIMMacro.rmse(backend=
"kernel")``: ``kernels/dscim_mvm.py dscim_counts``, the CUDA kernel on the
card and its plain version on the CPU).  They are integers equal to the
LUT oracle's, so every row is the reference's.

Normalization: RMS(psum_err) / (H * 255^2) * 100 %, the unsigned full
scale of the 128-row accumulation window (the convention under which the
paper's Table I is reproducible).

  PYTHONPATH=src python -m repro_torch.paper t1_rmse [--device cpu]
"""
from __future__ import annotations

import time

import torch

from ..core.macro import DSCIMMacro
from ..core.seed_search import calibrated_config
from ..device import resolve_device

__all__ = ["PAPER", "PRESETS", "run", "main"]

# the paper's Table I RMSE (%)
PAPER = {("dscim1", 64): 3.57, ("dscim1", 128): 2.03, ("dscim1", 256): 0.74,
         ("dscim2", 64): 3.81, ("dscim2", 128): 2.63, ("dscim2", 256): 0.84}
# (variant, L, point set) in row order
PRESETS = tuple((variant, L, mode) for variant in ("dscim1", "dscim2")
                for L in (64, 128, 256) for mode in ("paper", "opt"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_cols: int = 256, n_vec: int = 48, device=None):
    """One row per preset; ``us`` is the wall time of building the macro
    and its RMSE, with the device drained before each clock read."""
    dev = resolve_device(device)
    rows = []
    for variant, L, mode in PRESETS:
        _sync(dev)
        t0 = time.perf_counter()
        mac = DSCIMMacro(calibrated_config(variant, L, mode))
        r = mac.rmse(n_cols=n_cols, n_vec=n_vec, backend="kernel",
                     device=dev)
        _sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        rows.append({
            "name": f"t1_rmse/{variant}/L{L}/{mode}",
            "us": us,
            "rmse_pct": r["unsigned_fullscale"],
            "paper_pct": PAPER[(variant, L)],
            "bias": r["bias"],
        })
    return rows


def main(device=None):
    rows = run(device=device)
    for r in rows:
        print(f"{r['name']},{r['us']:.0f},"
              f"rmse={r['rmse_pct']:.3f}%;paper={r['paper_pct']}%;"
              f"bias={r['bias']:.0f}")
    return rows
