"""Normalization layers (port of ``repro/layers/norms.py``): parametric
RMSNorm and the per-head qk-norm of qwen3."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm", "qk_norm"]


def rmsnorm(x: torch.Tensor, params=None, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * (torch.mean(xf * xf, -1, keepdim=True) + eps) ** -0.5
    if params and "scale" in params:
        y = y * params["scale"]
    return y.to(dt)


def qk_norm(q: torch.Tensor, params=None, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3-style)."""
    return rmsnorm(q, params, eps)
