"""The integrity layer's uint32 digest, computed in int64 (torch has little
``uint32`` arithmetic on CUDA): the shared arithmetic of the reference's
``kvcache._csum_fold`` and ``qweights.plane_digest``.  This is the plain
version: the CPU's path, and the card's yardstick for the digest kernel
(``kernels/digest.py``), which is what CUDA tensors go through.

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

An element of at most 32 bits multiplies its weight (below 2**32) in one
int64 product with no split: its sign-extended integer (a 32-bit float's
bits as int32; a 16-bit float's zero-extended bits) is ``u32(x)`` mod
2**32 and its magnitude at most 2**31, so the product stays inside
int64.  The weights of a chunk of at most ``CACHED`` elements are kept
per (offset, length, multiplier, device): a page's and a small model's
planes then cost three kernels each (product, mask, sum), where the
sweeps of a small model are set by their launches.
"""
from __future__ import annotations

import torch

__all__ = ["GOLD", "M32", "u32", "fold", "fold_sum"]

GOLD = 2654435761                  # Knuth's golden-ratio multiplier
M32 = (1 << 32) - 1
CHUNK = 1 << 22                    # elements a partial sum covers
CACHED = 1 << 16                   # largest chunk whose weights are kept
_WEIGHTS: dict = {}


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


def _weights(s: int, n: int, mult: int, device) -> torch.Tensor:
    """``(2i+1) * GOLD * mult mod 2**32`` for i in [s, s+n), int64."""
    key = (s, n, mult, torch.device(device))
    w = _WEIGHTS.get(key)
    if w is None:
        i = torch.arange(s, s + n, dtype=torch.int64, device=device)
        w = _mul32((2 * i + 1) & M32, (GOLD * mult) & M32)
        if n <= CACHED:
            if len(_WEIGHTS) >= 256:
                _WEIGHTS.clear()
            _WEIGHTS[key] = w
    return w


def _narrow(x: torch.Tensor):
    """``x`` as integers congruent to ``u32(x)`` mod 2**32 with magnitude
    at most 2**31 (no copy for ints and 32-bit floats), or None for a
    dtype wider than 32 bits."""
    if x.element_size() > 4:
        return None
    if x.dtype.is_floating_point:
        return x.view(torch.int32) if x.element_size() == 4 else u32(x)
    return x


def fold_sum(x: torch.Tensor, n_lead: int, mult: int) -> torch.Tensor:
    """The digest over every axis of ``x`` past the first ``n_lead``, int64
    (*lead) congruent to it mod 2**32 and below 2**54 (``fold`` without
    its last mask, for digests that are added before one)."""
    lead = tuple(x.shape[:n_lead])
    flat = x.reshape(*lead, -1)
    n = flat.shape[-1]
    total = None
    for s in range(0, max(n, 1), CHUNK):
        part = flat[..., s:s + CHUNK]
        w = _weights(s, part.shape[-1], mult, x.device)
        small = _narrow(part)
        prod = small * w if small is not None else _mul32(u32(part), w)
        got = (prod & M32).sum(-1)
        total = got if total is None else (total + got) & M32
    return total


def fold(x: torch.Tensor, n_lead: int, mult: int) -> torch.Tensor:
    """The digest over every axis of ``x`` past the first ``n_lead``:
    int64 (*lead) in [0, 2**32)."""
    return fold_sum(x, n_lead, mult) & M32
