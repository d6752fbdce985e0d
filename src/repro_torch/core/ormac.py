"""Cycle-level OR-MAC simulation, the hardware oracle (port of
``repro/core/ormac.py``, in torch, vectorised over the output (m, n)).

Two circuits:

* the paper's remapped OR-MAC (DS-CIM, ``dscim_group_count`` for one
  column, ``dscim_counts_cycle`` for a whole (M, K) x (K, N) product):
  a shared PRNG pair, region-remapped rows, an OR gate per group of 4^k
  rows, a per-cycle adder across the groups and an accumulator over the
  L cycles.  The regions are disjoint, so the OR equals the sum;
  ``check_disjoint`` asserts that invariant;
* the conventional stochastic OR-MAC of [27] (``naive_or_count``):
  independent PRNG streams per row and no remapping, so simultaneous 1s
  collide in the OR gate (the 1s saturation error).

These build the explicit bitstream x OR x adder pipeline and cost
O(M·K·N·L) bits: test-sized operands only.  The count LUT, the all-L
bitmatmul and the count kernel (``core/macro.py``, ``kernels/
dscim_mvm.py``) are held against them.  Inputs may be numpy arrays or
tensors; the work runs on the device of ``a_shift`` (numpy: the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng as prng_lib
from .remap import group_size

__all__ = ["sng_bits", "dscim_bitstreams", "check_disjoint",
           "dscim_group_count", "dscim_counts_cycle", "naive_or_count"]

# product bits (rows x K x N x L) ``dscim_counts_cycle`` builds at once
MAX_BITS = 1 << 26


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device).to(torch.int32)


def _fold(u: torch.Tensor, k: int):
    """``core/remap.py fold`` on a tensor: reflected fold of 8-bit coords
    -> (block code in [0, 2^k), local coordinate in [0, 2^(8-k)))."""
    cur, code, size = u, torch.zeros_like(u), 256
    for _ in range(k):
        half = size >> 1
        hi = cur >= half
        cur = torch.where(hi, size - 1 - cur, cur)
        code = (code << 1) | hi.to(code.dtype)
        size = half
    return code, cur


def sng_bits(values, rand) -> torch.Tensor:
    """Plain SNG: bit_t = (rand_t < value).  values (...,), rand (L,) ->
    (..., L) uint8."""
    values = _t(values)
    rand = _t(rand, values.device)
    return (rand < values[..., None]).to(torch.uint8)


def _row_bits(shift: torch.Tensor, point: torch.Tensor, k: int,
              row_axis: int, use_col: bool):
    """The remapped SNG of every row of ``shift``: row h (along
    ``row_axis``) fires at cycle t iff the fold of the PRNG coordinate
    point_t lands in the row's block and its local coordinate is below
    the row's value (the comparator with inverted bits of Fig. 6(d)/(e))."""
    n = 1 << k
    rows = torch.arange(shift.shape[row_axis], device=shift.device) \
        % group_size(k)
    blk = rows // n if use_col else rows % n
    code, local = _fold(point, k)
    shape = [1] * shift.ndim
    shape[row_axis] = -1
    blk = blk.reshape(shape)[..., None]
    return (code == blk) & (local < shift[..., None])


def dscim_bitstreams(a_shift, w_shift, u, v, k: int):
    """Per-row remapped A_SC / W_SC bitstreams of one column, (H, L) uint8
    each.  a_shift / w_shift: shifted unsigned values in [0, 2^(8-k)), one
    per row (H,); u, v: the shared PRNG pair's L points."""
    a = _t(a_shift)
    w = _t(w_shift, a.device)
    a_bits = _row_bits(a, _t(u, a.device), k, 0, use_col=False)
    w_bits = _row_bits(w, _t(v, a.device), k, 0, use_col=True)
    return a_bits.to(torch.uint8), w_bits.to(torch.uint8)


def check_disjoint(p_bits, k: int) -> bool:
    """Invariant: within every OR group at most one product bit fires a
    cycle.  p_bits (H, L)."""
    p = torch.as_tensor(np.asarray(p_bits) if not isinstance(
        p_bits, torch.Tensor) else p_bits)
    H, L = p.shape
    G = group_size(k)
    return bool((p.reshape(H // G, G, L).to(torch.int32).sum(1) <= 1).all())


def dscim_group_count(a_shift, w_shift, u, v, k: int,
                      assert_disjoint: bool = False):
    """One DS-CIM column, cycle by cycle: returns (total count, per-cycle
    adder outputs (L,) int64).  per_cycle[t] sums the OR-gate outputs of
    the H/G groups at cycle t, so it is bounded by H/G (8 for DS-CIM1, 2
    for DS-CIM2: the paper's adder widths)."""
    a_bits, w_bits = dscim_bitstreams(a_shift, w_shift, u, v, k)
    p_bits = a_bits & w_bits
    if assert_disjoint and not check_disjoint(p_bits, k):
        raise AssertionError("remapped OR groups are not collision-free")
    H, L = p_bits.shape
    G = group_size(k)
    or_out = p_bits.reshape(H // G, G, L).amax(1)         # the OR gates
    per_cycle = or_out.to(torch.int64).sum(0)             # the adder
    return int(per_cycle.sum()), per_cycle                # the accumulator


def dscim_counts_cycle(a_shift, b_shift, u, v, k: int,
                       assert_disjoint: bool = True) -> torch.Tensor:
    """The cycle-level OR-MAC over a whole product: a_shift (M, K) and
    b_shift (K, N) shifted unsigned values -> (M, N) int64 counts, entry
    (m, n) being ``dscim_group_count(a_shift[m], b_shift[:, n], ...)``'s
    total.  The (rows, K, N, L) product bits are built a few rows at a
    time, up to ``MAX_BITS``; K must be a whole number of OR groups, as in
    the reference."""
    a = _t(a_shift)
    dev = a.device
    b = _t(b_shift, dev)
    M, K = a.shape
    N = b.shape[1]
    G = group_size(k)
    if K % G:
        raise ValueError(f"K={K} is not a whole number of {G}-row OR "
                         "groups")
    a_bits = _row_bits(a, _t(u, dev), k, 1, use_col=False)   # (M, K, L)
    w_bits = _row_bits(b, _t(v, dev), k, 0, use_col=True)    # (K, N, L)
    L = a_bits.shape[-1]
    out = torch.empty((M, N), dtype=torch.int64, device=dev)
    step = max(1, MAX_BITS // max(K * N * L, 1))
    for m0 in range(0, M, step):
        p = a_bits[m0:m0 + step, :, None, :] & w_bits[None]   # (m, K, N, L)
        p = p.reshape(p.shape[0], K // G, G, N, L)
        if assert_disjoint and bool((p.to(torch.int8).sum(2) > 1).any()):
            raise AssertionError("remapped OR groups are not "
                                 "collision-free")
        or_out = p.any(2)                                     # (m, K/G, N, L)
        out[m0:m0 + step] = or_out.sum(dim=(1, 3))
    return out


def naive_or_count(a_u8, w_u8, L: int, group: int, seed: int = 0,
                   kind: str = "lfsr"):
    """[27]-style conventional OR-MAC: independent PRNGs a row, no
    remapping.  a_u8 / w_u8: unshifted unsigned values in [0, 256), (H,).
    Each row compares its own PRNG pair (seeds drawn as the reference
    draws them); the OR gate saturates when several product bits are 1 in
    one cycle.  Returns (count, ideal sum of the product bits)."""
    a = _t(a_u8)
    w = _t(w_u8, a.device)
    H = a.shape[0]
    rng = np.random.default_rng(seed)
    counts_or = counts_sum = 0
    for g0 in range(0, H, group):
        n = min(g0 + group, H) - g0
        pts = []
        for i in range(n):
            su, sv = rng.integers(1, 255, 2)
            pts.append(prng_lib.make_points(kind, L, int(su), int(sv),
                                            param_u=i, param_v=i + 1))
        uu = _t(np.stack([p[0] for p in pts]), a.device)      # (n, L)
        vv = _t(np.stack([p[1] for p in pts]), a.device)
        p = (uu < a[g0:g0 + n, None]) & (vv < w[g0:g0 + n, None])
        counts_or += int(p.any(0).sum())
        counts_sum += int(p.sum())
    return counts_or, counts_sum
