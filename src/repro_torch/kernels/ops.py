"""Kernel-level operator API (port of ``repro/kernels/ops.py``): the full
DS-CIM psum estimate through the all-L count kernel, the exact int8
product it is compared against, and the folded point constants.

Not ported: ``ON_TPU`` and ``default_bits`` (the TPU dispatch and the
TPU's bf16 bit-operand policy have no counterpart here: a wrapper's route
follows its tensors' device), and the Pallas tile arguments ``bm``,
``bn``, ``bk``, ``bl`` and ``interpret`` (the count kernel's tile is
``tune``'s: kernels/autotune.py picks it on the card).  Nor is the
reference's K padding: it pads K with x = -128, w = 0 to its tile and then
cancels what the pad rows add to the correction terms; here nothing is
padded and the estimate is the unpadded formula of ``ref.py
dscim_mvm_ref``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import prng as prng_lib
from ..core.macro import DSCIMConfig
from ..core.remap import fold
from .dscim_mvm import dscim_counts
from .int8_matmul import int8_matmul

__all__ = ["dscim_mvm", "mvm_from_counts", "int8_matmul", "fold_constants",
           "round_up"]


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m >= x (tile/pad arithmetic)."""
    return -(-x // m) * m


@functools.lru_cache(maxsize=32)
def fold_constants(cfg: DSCIMConfig):
    """Folded PRNG coordinates (cu, lu, cv, lv) of ``cfg``'s points, each
    an (L,) int32 CPU tensor."""
    u, v = prng_lib.make_points(cfg.points, cfg.length, cfg.seed_u,
                                cfg.seed_v, cfg.param_u, cfg.param_v)
    cu, lu = fold(u.astype(np.int32), cfg.k)
    cv, lv = fold(v.astype(np.int32), cfg.k)
    return tuple(torch.as_tensor(t, dtype=torch.int32)
                 for t in (cu, lu, cv, lv))


def mvm_from_counts(x_i8, w_i8, counts, cfg: DSCIMConfig) -> torch.Tensor:
    """The estimate of ``ref.py dscim_mvm_ref`` from an (M, N) count matrix:

        scale*C - 128*Σx - 128*Σ(w+128)  (+ center-truncation terms)

    with K the caller's own, in the K·δ² term too."""
    x32 = x_i8.to(torch.int32)
    w32 = w_i8.to(torch.int32)
    out = cfg.scale * counts.to(torch.float32) \
        - 128.0 * x32.sum(-1, keepdim=True).to(torch.float32) \
        - 128.0 * (w32 + 128).sum(0, keepdim=True).to(torch.float32)
    if cfg.trunc == "center":
        k = cfg.k
        delta = (2 ** k - 1) / 2.0
        a = (x32 + 128) >> k
        b = (w32 + 128) >> k
        out = out + (2 ** k) * delta * (
            a.sum(-1, keepdim=True) + b.sum(0, keepdim=True)
        ).to(torch.float32) + x32.shape[-1] * delta * delta
    return out


def dscim_mvm(x_i8, w_i8, cfg: DSCIMConfig, *, tune: bool = False
              ) -> torch.Tensor:
    """DS-CIM psum estimate (M, N) f32 of int8 x (M, K) @ w (K, N), with
    the OR counts over all L points from ``dscim_mvm.dscim_counts`` (the
    count kernel on CUDA tensors; ``tune``: at the tile autotuner's
    winner, the same counts)."""
    x = x_i8.to(torch.int8)
    w = w_i8.to(torch.int8)
    counts = dscim_counts(x, w, *fold_constants(cfg), k=cfg.k,
                          length=cfg.length, tune=tune)
    return mvm_from_counts(x, w, counts, cfg)
