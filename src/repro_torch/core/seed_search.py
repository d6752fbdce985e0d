"""Sec. IV-C: the PRNG-type x seed search minimizing the OR-MAC's RMSE,
and its pinned winners (port of ``repro/core/seed_search.py``).

The count LUT is a deterministic function of the point sequence, so the
search is a host-side optimization in numpy: ``rmse_numpy`` scores one
candidate's LUT on fixed random data, ``search`` grid-searches kinds,
seeds and parameters.  ``CALIBRATED`` pins the reference's winners as the
shipped presets; its values are (kind, seed_u, seed_v, param_u, param_v,
trunc)."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from . import prng
from .remap import build_count_lut, group_size

__all__ = ["rmse_numpy", "Candidate", "search", "CALIBRATED",
           "calibrated_config"]


def rmse_numpy(lut: np.ndarray, k: int, length: int, rows: int = 128,
               n_vec: int = 48, n_cols: int = 256, seed: int = 0,
               trunc: str = "floor", dist: str = "uniform"):
    """Vectorized RMSE of the DS-CIM H-row MAC for the count LUT ``lut``,
    on the reference's operands for ``seed``.  Returns
    (rmse_unsigned_pct, rmse_signed_pct, bias_abs), normalized to the
    unsigned (H*255^2, the calibration matching Table I) and the signed
    (H*128^2) full scale."""
    G = group_size(k)
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        x = rng.integers(-128, 128, (n_vec, rows), dtype=np.int64)
        w = rng.integers(-128, 128, (rows, n_cols), dtype=np.int64)
    elif dist == "gaussian":
        x = np.clip(np.round(rng.normal(0, 42, (n_vec, rows))), -128,
                    127).astype(np.int64)
        w = np.clip(np.round(rng.normal(0, 42, (rows, n_cols))), -128,
                    127).astype(np.int64)
    else:
        raise ValueError(dist)
    exact = x @ w
    a = (x + 128) >> k                       # (M, H)
    b = (w + 128) >> k                       # (H, N)
    blk = np.arange(rows) % G
    counts = lut[blk[None, :, None], a[:, :, None], b[None, :, :]].sum(axis=1)
    scale = (4 ** k) * 65536.0 / length
    est = scale * counts - 128.0 * x.sum(-1, keepdims=True) \
        - 128.0 * (w + 128).sum(0, keepdims=True)
    if trunc == "center":
        delta = (2 ** k - 1) / 2.0
        est = est + (2 ** k) * delta * (a.sum(-1, keepdims=True)
                                        + b.sum(0, keepdims=True)) \
            + rows * delta * delta
    err = est - exact
    rms = float(np.sqrt((err ** 2).mean()))
    return (100.0 * rms / (rows * 255 * 255),
            100.0 * rms / (rows * 128 * 128),
            float(err.mean()))


@dataclasses.dataclass
class Candidate:
    kind: str
    seed_u: int
    seed_v: int
    param_u: int | None
    param_v: int | None
    rmse_unsigned: float
    rmse_signed: float
    bias: float


def search(k: int, length: int, trunc: str = "floor",
           kinds=("lfsr", "galois", "lcg", "weyl", "xorshift"),
           seeds=(1, 7, 23, 51, 91, 113, 151, 199, 233),
           params=(0, 1, 2, 3), rows: int = 128, top: int = 5,
           n_vec: int = 48, n_cols: int = 256, data_seed: int = 0):
    """Grid-search point configurations; returns the ``top`` candidates
    by unsigned RMSE (a stable sort: ties keep the grid's order).  The
    low-discrepancy kinds (sobol, vdc, r2) take no parameters."""
    results: list[Candidate] = []
    for kind in kinds:
        if kind in ("sobol", "vdc", "r2"):
            grid = itertools.product(seeds, seeds, (None,), (None,))
        else:
            grid = itertools.product(seeds, seeds, params, params)
        for su, sv, pu, pv in grid:
            u, v = prng.make_points(kind, length, su, sv, pu, pv)
            lut = build_count_lut(u, v, k)
            ru, rs, bias = rmse_numpy(lut, k, length, rows, n_vec, n_cols,
                                      data_seed, trunc)
            results.append(Candidate(kind, su, sv, pu, pv, ru, rs, bias))
    results.sort(key=lambda c: c.rmse_unsigned)
    return results[:top]


CALIBRATED: dict[tuple[str, int, str], tuple] = {
    ("dscim1", 64, "paper"): ("lfsr", 233, 199, 0, 0, "floor"),
    ("dscim1", 128, "paper"): ("lfsr", 91, 23, 1, 0, "floor"),
    ("dscim1", 256, "paper"): ("galois", 199, 91, 1, 0, "floor"),
    ("dscim2", 64, "paper"): ("lfsr", 233, 199, 0, 0, "floor"),
    ("dscim2", 128, "paper"): ("lfsr", 7, 91, 1, 0, "floor"),
    ("dscim2", 256, "paper"): ("galois", 51, 233, 1, 0, "floor"),
    ("dscim1", 64, "opt"): ("r2", 17, 0, None, None, "center"),
    ("dscim1", 128, "opt"): ("sobol", 138, 172, None, None, "center"),
    ("dscim1", 256, "opt"): ("sobol", 0, 60, None, None, "center"),
    ("dscim2", 64, "opt"): ("sobol", 138, 219, None, None, "center"),
    ("dscim2", 128, "opt"): ("r2", 77, 0, None, None, "center"),
    ("dscim2", 256, "opt"): ("r2", 91, 0, None, None, "center"),
}


def calibrated_config(variant: str, length: int, mode: str = "paper"):
    """Build the pinned DSCIMConfig for ('dscim1'|'dscim2', L, 'paper'|'opt')."""
    from .macro import DSCIMConfig
    kind, su, sv, pu, pv, trunc = CALIBRATED[(variant, length, mode)]
    k = 2 if variant == "dscim1" else 3
    name = {"dscim1": "DS-CIM1", "dscim2": "DS-CIM2"}[variant]
    return DSCIMConfig(k=k, length=length, points=kind, seed_u=su, seed_v=sv,
                       param_u=pu, param_v=pv, trunc=trunc,
                       name=f"{name}/L{length}/{mode}")
