"""Rotary position embeddings, half-rotation convention (port of
``repro/layers/rope.py``)."""
from __future__ import annotations

import torch

__all__ = ["rope_angles", "apply_rope"]


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """positions (...,) int -> (cos, sin) each (..., head_dim/2) f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
