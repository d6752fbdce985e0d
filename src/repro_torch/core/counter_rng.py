"""Counter-based random numbers: a pure function of integer keys and an
element index, in plain torch integer ops.

The port draws its random numbers (the sampler's Gumbel noise, the DS-CIM
noise backends' Gaussian error) from a 32-bit hash of the integers that
name the draw, not from a ``torch.Generator``.  So a draw

* depends on nothing but its key and its index: a CUDA graph replays it
  without generator state or a host read, and a draw that is skipped
  (a rejected speculative draft) consumes nothing;
* is the same on the CPU and on the card: the hash is exact integer
  arithmetic in int64 (every product stays below 2^63), and only the
  float transforms after it (``log``, ``cos``) round differently.

``pcg`` is the PCG-RXS-M-XS output permutation used as a hash (Jarzynski
and Olano, "Hash Functions for GPU Rendering", 2020); ``mix`` folds one
more integer into a key.  Both take Python ints or int64 tensors holding
values in [0, 2^32).
"""
from __future__ import annotations

import math

import torch

__all__ = ["pcg", "mix", "fold", "uniforms", "normals"]

M32 = 0xFFFFFFFF


def pcg(v):
    """32-bit hash of v in [0, 2^32) (int or int64 tensor)."""
    state = (v * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def mix(h, x):
    """Fold the integer ``x`` (any int64 value) into the key ``h``."""
    return pcg(h ^ pcg(x & M32))


def fold(*xs) -> int:
    """One key from a sequence of Python ints, folded in order."""
    h = 0
    for x in xs:
        h = mix(h, int(x))
    return int(h)


def _unit(h: torch.Tensor) -> torch.Tensor:
    """Hash -> f32 uniform in (0, 1): the top 24 bits, centred."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """keys (...,) int64 -> (..., n) f32 uniforms in (0, 1), element j of
    a row a function of (its key, j) only."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    return _unit(mix(keys[..., None], j))


def normals(key: int, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` (f32), element i a function of
    (``key``, i) only: Box-Muller over two uniforms hashed from
    (key, i, 0) and (key, i, 1)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    hk = mix(pcg(key & M32), i)
    u1 = _unit(mix(hk, 0))
    u2 = _unit(mix(hk, 1))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(shape)
