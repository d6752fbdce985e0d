"""Gradient compression for the slow cross-pod axis: symmetric per-tensor
int8 with error feedback (port of ``repro/optim/compression.py``).

``compressed_psum_tree`` is the all-reduce over one mesh axis
(``parallel.ParallelCtx``): every rank requantizes its gradient (plus its
error feedback) against the axis' largest scale, the int8 payloads are
summed exactly, and the sum is rescaled; what the int8 payload dropped
stays in the rank's error state for the next step.
"""
from __future__ import annotations

import torch

from ..core.quant import RECIP_127
from ..tree import leaves, unflatten

__all__ = ["compress", "decompress", "init_error", "compressed_psum_tree"]


def compress(g: torch.Tensor):
    """Symmetric per-tensor int8: (q int8, scale f32 0-d)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error(params):
    """Zero f32 error-feedback state shaped as ``params``."""
    if isinstance(params, dict):
        return {k: init_error(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def compressed_psum_tree(grads, err, axis: str, par):
    """The mean of ``grads`` over the ranks of ``axis`` through int8
    payloads, with error feedback ``err`` (f32, shaped as ``grads``):
    returns (mean-reduced grads in their dtypes, the new error state).

    Per leaf: g32 = g + e; the scale s = max(amax(g32), 1e-12) / 127 is
    maxed over the axis; q = clip(round(g32 / s_max), -127, 127) (whole
    values in f32) is summed over the axis, exactly below 2^24; the mean
    is sum * s_max / n and the new error g32 - q * s_max.  The scale is
    ``amax * (1/127)`` rounded to f32, which is what the reference's
    ``/ 127.0`` becomes in the jitted ``shard_map`` it runs under."""
    n = par.sizes[axis]

    def one(g, e):
        g32 = g.to(torch.float32) + e
        s = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) \
            * RECIP_127[torch.float32]
        s_max = par.pmax(s, axis)
        q = torch.clamp(torch.round(g32 / s_max), -127, 127)
        total = par.psum(q, axis)
        return (total * s_max / n).to(g.dtype), g32 - q * s_max

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
