"""Normalization layers (port of ``repro/layers/norms.py``): parametric
RMSNorm (qwen/llama family), LayerNorm with optional scale and bias
(non-parametric with empty params: OLMo) and the per-head qk-norm of
qwen3."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm", "layernorm", "qk_norm"]


def rmsnorm(x: torch.Tensor, params=None, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * (torch.mean(xf * xf, -1, keepdim=True) + eps) ** -0.5
    if params and "scale" in params:
        y = y * params["scale"]
    return y.to(dt)


def layernorm(x: torch.Tensor, params=None, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm over the last axis, in f32 (mean, then variance, then the
    optional ``scale`` and ``bias``), cast back to ``x``'s dtype;
    non-parametric when ``params`` is empty (OLMo)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * (var + eps) ** -0.5
    if params and "scale" in params:
        y = y * params["scale"]
    if params and "bias" in params:
        y = y + params["bias"]
    return y.to(dt)


def qk_norm(q: torch.Tensor, params=None, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3-style)."""
    return rmsnorm(q, params, eps)
