"""Symmetric int8 quantization and the FP8 (E4M3) path of the paper's LLM
experiment (port of ``repro/core/quant.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedTensor", "quantize_int8", "dequantize_int8", "fp8_cast",
           "fp8_to_int8_aligned"]

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
    ``jnp.round``.

    Differentiated, it has the reference's gradient: none through ``q``
    (the int8 cut), and through ``scale`` the rules JAX applies to
    ``max(abs(x))``: a tied maximum shares the gradient evenly
    (``torch.amax`` as ``jnp.max``), ``abs`` passes none at 0, and a
    window whose max is below ``eps`` gets none (one at ``eps`` half)."""
    dims = axis if isinstance(axis, tuple) else (axis,)
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    # eps as a 0-d CPU tensor in x's dtype, as JAX's weakly typed eps: a
    # scalar operand on any device (no fill kernel, no copy), and
    # ``jnp.maximum``'s gradient, half of it at a tie with eps
    amax = torch.maximum(amax, torch.tensor(eps, dtype=amax.dtype))
    scale = amax * RECIP_127[x.dtype]
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale.to(torch.float32), axis)


def dequantize_int8(qt: QuantizedTensor) -> torch.Tensor:
    return qt.q.to(torch.float32) * qt.scale


# float8_e4m3fn's largest finite value is 448; 464, half way to the next
# step (480, which the format spends on NaN), is the largest magnitude
# that rounds (to even) back to 448
FP8_E4M3_NAN_ABOVE = 464.0


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through float8_e4m3fn to f32 (the paper's LLM-FP4/FP8
    recipe [29]), as the reference's ``astype(float8_e4m3fn)`` does it:
    round to nearest even, and a magnitude above 464 (inf included)
    becomes NaN.  ``torch``'s cast saturates such a value to +-448
    instead, so the NaN is put back explicitly; 464 itself is a tie that
    rounds to even, to 448, in both."""
    y = x.to(torch.float8_e4m3fn).to(torch.float32)
    return torch.where(torch.abs(x) > FP8_E4M3_NAN_ABOVE,
                       torch.full_like(y, float("nan")), y)


def fp8_to_int8_aligned(x: torch.Tensor, group: int = 128):
    """Paper Sec. V: FP8 activations and weights aligned to INT8 with a
    granularity of 128 (the method of RedCIM [30]).  The FP8 values of
    each contiguous ``group`` along the last axis (zero-padded to a whole
    group) share one scale ``max(amax, 1e-8) / 127``, and each group is
    quantized again to int8.  Returns (int8 (..., n_groups, group), f32
    scales (..., n_groups, 1), pad).

    Bitwise the reference called eagerly, as its tests call it: the
    scale is a true division by 127 (inside ``jit`` XLA multiplies by the
    reciprocal instead, which moves a few scales by an ulp).  A group
    holding a NaN (a magnitude above 464 before the cast) has a NaN scale
    and int8 values 0, as the reference's NaN-to-int conversion gives."""
    xf = fp8_cast(x)
    pad = (-xf.shape[-1]) % group
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    g = xf.reshape(*xf.shape[:-1], -1, group)
    amax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    r = torch.clamp(torch.round(g / scale), -127, 127)
    q = torch.nan_to_num(r, nan=0.0).to(torch.int8)
    return q, scale, pad
