"""Sample-region remapping (the paper's core trick, Sec. IV-B): the numpy
host-side half of ``repro/core/remap.py``, kept as the port's own copy.

Rows sharing an OR gate right-shift their (unsigned) data by ``k`` bits and
are remapped into the 4^k disjoint blocks of a 2^k x 2^k partition of the 2D
sampling map, as a reflected binary fold of each coordinate.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fold", "row_block", "point_block", "build_count_lut",
           "group_size", "shifted_bits"]


def group_size(k: int) -> int:
    """Rows per OR gate: OR4 (k=1), OR16 (k=2), OR64 (k=3)."""
    return 4 ** k


def shifted_bits(k: int) -> int:
    """Post-shift data width S = 2^(8-k); shifted values live in [0, S)."""
    return 256 >> k


def fold(u: np.ndarray, k: int):
    """Reflected fold of 8-bit coords -> (block_code in [0,2^k), local in [0,S)).

    Level i: if the coordinate is in the upper half of the remaining
    interval, mirror it (x -> size-1-x) and set block bit i."""
    cur = u.astype(np.int32)
    code = np.zeros_like(cur)
    size = 256
    for _ in range(k):
        half = size >> 1
        hi = cur >= half
        cur = np.where(hi, size - 1 - cur, cur)
        code = (code << 1) | hi.astype(np.int32)
        size = half
    return code, cur


def row_block(row_in_group, k: int):
    """Fixed wiring row -> (u-block code, v-block code): row g of a 4^k
    group owns block (g mod 2^k, g div 2^k)."""
    n = 1 << k
    return row_in_group % n, row_in_group // n


def point_block(cu, cv, k: int):
    """Fixed wiring sampling point -> owning row (inverse of ``row_block``)."""
    return cv * (1 << k) + cu


def build_count_lut(points_u: np.ndarray, points_v: np.ndarray,
                    k: int) -> np.ndarray:
    """Joint-count LUT: LUT[g, a, w] = #{t : point_t in region_g(a, w)},
    shape (4^k, S, S) int32: the 2D exclusive cumulative histogram of the
    folded in-block points (index 0 is zero, S-1 covers [0, S-1))."""
    S = shifted_bits(k)
    G = group_size(k)
    cu, lu = fold(points_u.astype(np.int32), k)
    cv, lv = fold(points_v.astype(np.int32), k)
    lut = np.zeros((G, S, S), np.int32)
    n = 1 << k
    for g in range(G):
        bc, br = g % n, g // n
        m = (cu == bc) & (cv == br)
        if not m.any():
            continue
        hist, _, _ = np.histogram2d(
            lu[m], lv[m], bins=(S, S), range=((0, S), (0, S)))
        cs = np.cumsum(np.cumsum(hist, axis=0), axis=1)
        lut[g, 1:, 1:] = cs[:-1, :-1]
    return lut
