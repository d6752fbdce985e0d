"""Gradient compression: symmetric per-tensor int8 with error feedback
(port of ``compress``, ``decompress`` and ``init_error`` from
``repro/optim/compression.py``).  The reference's
``compressed_psum_tree``, the all-reduce over a slow mesh axis, is part
of training under a mesh (ROADMAP A13b)."""
from __future__ import annotations

import torch

__all__ = ["compress", "decompress", "init_error"]


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
