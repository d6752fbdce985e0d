"""Blocked-points DS-CIM counts (port of
``repro/kernels/dscim_mvm_blocked.py``).

After region remapping, row h's rectangle lives entirely inside its own
block of the 2^k x 2^k partition, so each row only ever meets the <= pmax
sampling points of its block.  ``block_point_tables`` lists those points'
local coordinates per block; pad slots hold S, which no shifted value
a < S exceeds, so pads never fire.

``dscim_counts_blocked`` computes the raw count matrix over each row's own
block points (row h uses block h mod G):

* on a CUDA tensor it launches the count kernel shared with
  ``dscim_mvm.dscim_counts`` (``csrc/dscim_counts.cu``), with bit-mask
  tables built from ``block_point_tables``;
* on a CPU tensor it runs ``dscim_counts_blocked_plain``, the reference's
  {0,1} expansion over K·pmax, chunked over N.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.macro import DSCIMConfig
from . import build
from .dscim_mvm import (BIT_BUDGET, check_exact_matmuls,
                        count_mask_tables, launch_counts, points_by_block)
from .ops import fold_constants

__all__ = ["block_point_tables", "count_tables", "dscim_counts_blocked",
           "dscim_counts_blocked_plain", "LAUNCHES"]

LAUNCHES = build.LaunchCounter("dscim_counts_blocked")


@functools.lru_cache(maxsize=32)
def block_point_tables(cfg: DSCIMConfig):
    """(G, pmax) int32 tables of per-block local point coords (lu, lv),
    pad slots = S; pmax is rounded up to even as in the reference."""
    tu, tv = points_by_block(*fold_constants(cfg), cfg.k)
    pmax = tu.shape[1] + tu.shape[1] % 2
    pad = ((0, 0), (0, pmax - tu.shape[1]))
    return (np.pad(tu, pad, constant_values=cfg.sbits).astype(np.int32),
            np.pad(tv, pad, constant_values=cfg.sbits).astype(np.int32),
            pmax)


@functools.lru_cache(maxsize=32)
def count_tables(cfg: DSCIMConfig, device: torch.device):
    """The kernel's (G, S, W) bit-mask tables for ``cfg``, on ``device``."""
    tu, tv, _ = block_point_tables(cfg)
    return tuple(torch.as_tensor(t, device=device)
                 for t in count_mask_tables(tu, tv, cfg.sbits))


def dscim_counts_blocked_plain(x_i8, w_i8, cfg: DSCIMConfig) -> torch.Tensor:
    """Plain PyTorch blocked counts: abits (M, K·pmax) @ wbits (K·pmax, N)
    over each row's block table (row h -> block h mod G), in f32 (exact
    integers), in chunks of N."""
    check_exact_matmuls(x_i8, "dscim_counts_blocked_plain")
    dev = x_i8.device
    k = cfg.k
    a = (x_i8.to(torch.int32) + 128) >> k
    b = (w_i8.to(torch.int32) + 128) >> k
    (M, K), N = a.shape, b.shape[1]
    tu, tv, pmax = block_point_tables(cfg)
    blk = torch.arange(K, device=dev) % cfg.group
    lu = torch.as_tensor(tu, device=dev)[blk]                 # (K, pmax)
    lv = torch.as_tensor(tv, device=dev)[blk]
    abit = (lu[None] < a[:, :, None]).to(torch.float32).reshape(M, -1)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    nc = max(1, BIT_BUDGET // max(K * pmax, 1))
    for n0 in range(0, N, nc):
        bb = b[:, n0:n0 + nc]
        wbit = (lv[:, :, None] < bb[:, None, :]).to(torch.float32)
        out[:, n0:n0 + nc] = abit @ wbit.reshape(K * pmax, -1)
    return out


def dscim_counts_blocked(x_i8, w_i8, cfg: DSCIMConfig) -> torch.Tensor:
    """OR-accumulated counts (M, N) f32 of int8 x (M, K) and w (K, N) over
    each row's own block points (row h -> block h mod G)."""
    x = x_i8.to(torch.int8)
    w = w_i8.to(torch.int8)
    if x.device.type == "cpu":
        return dscim_counts_blocked_plain(x, w, cfg)
    if x.device.type != "cuda":
        raise ValueError(
            f"no dscim_counts_blocked route for device {x.device}")
    ta, tb = count_tables(cfg, x.device)
    return launch_counts(x.contiguous(), w.contiguous(), ta, tb, cfg.k,
                         LAUNCHES)
