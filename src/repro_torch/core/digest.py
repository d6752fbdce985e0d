"""The integrity layer's uint32 digest, computed in int64 (torch has little
``uint32`` arithmetic on CUDA): the shared arithmetic of the reference's
``kvcache._csum_fold`` and ``qweights.plane_digest``.

A digest is ``sum_i (2i+1) * GOLD * mult * u32(x_i) mod 2**32`` over a
flattened array.  Every per-element weight is odd, hence invertible mod
2**32, so a change to any single element (any bit, the sign bit of a f32
scale included) always moves it; ``mult`` (odd, distinct per plane) keeps
a flip in one plane from cancelling one at the same offset in another.

Every value here is an int64 tensor holding a uint32 in [0, 2**32).  A
product of two such values can pass 2**63, so ``_mul32`` splits one
factor into 16-bit halves and no partial product passes 2**48.  Sums run
over chunks of ``CHUNK`` elements and are reduced mod 2**32 after each,
so no int64 copy of a whole plane (the LM head's is 155 M elements at
full width) is ever made.  Integer sums are exact in any order: the
digest is bitwise the reference's on every device.
"""
from __future__ import annotations

import torch

__all__ = ["GOLD", "M32", "u32", "fold"]

GOLD = 2654435761                  # Knuth's golden-ratio multiplier
M32 = (1 << 32) - 1
CHUNK = 1 << 22                    # elements a partial sum covers


def u32(x: torch.Tensor) -> torch.Tensor:
    """Each element's uint32 value as int64: integers widen with sign
    extension and wrap (numpy's and XLA's ``astype(uint32)``: int8 -1 is
    0xFFFFFFFF), floats are bitcast at their own width (bf16 to 16 bits,
    f32 to 32), not converted."""
    if x.dtype.is_floating_point:
        width = x.element_size()
        bits = {2: torch.int16, 4: torch.int32}[width]
        return x.view(bits).to(torch.int64) & ((1 << (8 * width)) - 1)
    return x.to(torch.int64) & M32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2**32 for int64 values in [0, 2**32); ``b`` a tensor or
    an int."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def fold(x: torch.Tensor, n_lead: int, mult: int) -> torch.Tensor:
    """The digest over every axis of ``x`` past the first ``n_lead``:
    int64 (*lead) in [0, 2**32)."""
    lead = tuple(x.shape[:n_lead])
    flat = x.reshape(*lead, -1)
    n = flat.shape[-1]
    c = (GOLD * mult) & M32
    total = torch.zeros(lead, dtype=torch.int64, device=x.device)
    for s in range(0, n, CHUNK):
        part = flat[..., s:s + CHUNK]
        i = torch.arange(s, s + part.shape[-1], dtype=torch.int64,
                         device=x.device)
        w = _mul32((2 * i + 1) & M32, c)
        total = (total + _mul32(u32(part), w).sum(-1)) & M32
    return total
