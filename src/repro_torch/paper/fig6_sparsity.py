"""Fig. 6(c): OR-accumulation error against product sparsity.

The conventional S-CIM (independent PRNGs a row, [27]) saturates as
sparsity drops; DS-CIM's remapped OR is collision-free at every sparsity,
with a uniform error floor: the paper's core qualitative claim.  The
conventional OR-MAC is ``core/ormac.py naive_or_count`` (host, the
reference's seeds); the DS-CIM estimate is ``DSCIMMacro.mvm(backend=
"kernel")``, the count kernel on the card.

  PYTHONPATH=src python -m repro_torch.paper fig6_sparsity [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.macro import DSCIMMacro
from ..core.ormac import naive_or_count
from ..core.seed_search import calibrated_config
from ..device import resolve_device

__all__ = ["LEVELS", "run", "main"]

LEVELS = (16, 48, 96, 160, 224, 255)     # activation magnitude caps


def run(H: int = 128, L: int = 256, n_trials: int = 8, device=None):
    """Sweep the input magnitude (so the product sparsity) and measure the
    relative error of OR-accumulated against exact sums, both circuits."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    mac = DSCIMMacro(calibrated_config("dscim1", L, "paper"))
    rows = []
    for level in LEVELS:
        err_naive, err_ds = [], []
        for t in range(n_trials):
            a = rng.integers(0, level + 1, H)
            w = rng.integers(0, level + 1, H)
            # conventional: unsigned OR-MAC16, independent streams
            or_c, _ = naive_or_count(a, w, L=L, group=16, seed=t)
            exact_p = float((a * w).sum()) / 65536 * L   # expected sum of 1s
            err_naive.append(abs(or_c - exact_p) / max(L, 1))
            # DS-CIM: estimate of the same unsigned sum via remapped OR
            x = (a.astype(np.int64) - 128)[None, :]
            wm = (w.astype(np.int64) - 128)[:, None]
            est = float(mac.mvm(
                torch.as_tensor(x, dtype=torch.int32, device=dev),
                torch.as_tensor(wm, dtype=torch.int32, device=dev),
                backend="kernel")[0, 0])
            exact = float((x * wm.T).sum())
            err_ds.append(abs(est - exact) / (H * 255 * 255))
        sparsity = 1.0 - (level / 255.0 / 2) ** 2
        rows.append({
            "name": f"fig6c/level{level}",
            "product_sparsity": round(sparsity, 3),
            "naive_or_err": float(np.mean(err_naive)),
            "dscim_err_pct": 100 * float(np.mean(err_ds)),
        })
    return rows


def main(device=None):
    rows = run(device=device)
    for r in rows:
        print(f"{r['name']},0,sparsity={r['product_sparsity']};"
              f"naive={r['naive_or_err']:.4f};dscim={r['dscim_err_pct']:.3f}%")
    # headline: the naive error grows > 3x from sparse to dense, DS-CIM's
    # stays about flat
    lo, hi = rows[0], rows[-1]
    print(f"fig6c/summary,0,naive_growth="
          f"{hi['naive_or_err'] / max(lo['naive_or_err'], 1e-9):.1f}x;"
          f"dscim_growth="
          f"{hi['dscim_err_pct'] / max(lo['dscim_err_pct'], 1e-9):.1f}x")
    return rows
