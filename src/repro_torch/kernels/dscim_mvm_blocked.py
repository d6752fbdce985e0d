"""Blocked-points tables of the DS-CIM estimator (numpy; port of
``block_point_tables`` in ``repro/kernels/dscim_mvm_blocked.py``).

After region remapping, row h's rectangle lives entirely inside its own
block of the 2^k x 2^k partition, so each row only ever meets the <= pmax
sampling points of its block.  These (G, pmax) tables list those points'
local coordinates; pad slots hold S, which no shifted value a < S exceeds,
so pads never fire.
"""
from __future__ import annotations

import functools

import numpy as np

from ..core import prng as prng_lib
from ..core.macro import DSCIMConfig
from ..core.remap import fold, point_block, shifted_bits

__all__ = ["block_point_tables"]


@functools.lru_cache(maxsize=32)
def block_point_tables(cfg: DSCIMConfig):
    """(G, pmax) int32 tables of per-block local point coords (lu, lv),
    pad slots = S; pmax is rounded up to even as in the reference."""
    u, v = prng_lib.make_points(cfg.points, cfg.length, cfg.seed_u,
                                cfg.seed_v, cfg.param_u, cfg.param_v)
    cu, lu = fold(u.astype(np.int32), cfg.k)
    cv, lv = fold(v.astype(np.int32), cfg.k)
    G = cfg.group
    S = shifted_bits(cfg.k)
    blk = point_block(cu, cv, cfg.k)
    counts = np.bincount(blk, minlength=G)
    pmax = max(int(counts.max()), 1)
    pmax = int(np.ceil(pmax / 2) * 2)
    tab_u = np.full((G, pmax), S, np.int32)
    tab_v = np.full((G, pmax), S, np.int32)
    fill = np.zeros(G, np.int32)
    for t in range(cfg.length):
        g = int(blk[t])
        tab_u[g, fill[g]] = lu[t]
        tab_v[g, fill[g]] = lv[t]
        fill[g] += 1
    return tab_u, tab_v, pmax
