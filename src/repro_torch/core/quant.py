"""Symmetric int8 quantization (port of ``repro/core/quant.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedTensor", "quantize_int8"]

# 1/127 rounded to each compute dtype, as a Python float: a scalar operand
# costs no host-to-device copy (a device tensor made per call would, and
# that copy synchronizes the stream), and the multiply still sees the
# constant in x's dtype, as XLA's weakly typed ``* (1.0 / 127.0)`` does
RECIP_127 = {dt: float(torch.tensor(1.0 / 127.0, dtype=dt))
              for dt in (torch.float32, torch.bfloat16, torch.float16)}


class QuantizedTensor(NamedTuple):
    q: torch.Tensor          # int8 values
    scale: torch.Tensor      # f32 per-channel/group scales (keepdim layout)
    axis: object


def quantize_int8(x: torch.Tensor, axis=-1, eps: float = 1e-8
                  ) -> QuantizedTensor:
    """q = round(x / s), s = max|x| / 127, computed in ``x``'s dtype.

    The scale is ``amax * (1/127)``, an explicit reciprocal multiply, as the
    reference writes it (XLA turns a divide by a constant into exactly that
    inside jitted graphs); ``torch.round`` rounds half to even like
    ``jnp.round``."""
    dims = axis if isinstance(axis, tuple) else (axis,)
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    scale = torch.clamp_min(amax, eps) * RECIP_127[x.dtype]
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale.to(torch.float32), axis)
