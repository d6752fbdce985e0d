"""DS-CIM macro model (port of ``repro/core/macro.py``): the static macro
configuration plus a torch joint-count LUT oracle for the tests.

``psum_hat = scale * C  -  128*Σx  -  128*Σw'``        (Eq. 4)

where ``C`` is the OR-accumulated count over L cycles and ``scale =
4^k * 2^16 / L``.  DS-CIM1 = OR-MAC16 (k=2), DS-CIM2 = OR-MAC64 (k=3).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from . import prng
from .remap import build_count_lut, group_size, shifted_bits

__all__ = ["DSCIMConfig", "DSCIMMacro", "dscim1", "dscim2"]


@dataclasses.dataclass(frozen=True)
class DSCIMConfig:
    """Static configuration of one DS-CIM macro variant."""
    k: int = 2                      # region-remap shift: OR group = 4^k rows
    length: int = 256               # bitstream length L
    points: str = "sobol"           # PRNG pair kind (see core.prng)
    seed_u: int = 0
    seed_v: int = 0
    param_u: int | None = None
    param_v: int | None = None
    trunc: Literal["floor", "center"] = "floor"
    rows: int = 128                 # physical rows per column
    name: str = "dscim"

    @property
    def group(self) -> int:
        return group_size(self.k)

    @property
    def sbits(self) -> int:
        return shifted_bits(self.k)

    @property
    def scale(self) -> float:
        return (4 ** self.k) * 65536.0 / self.length


def dscim1(length: int = 256, **kw) -> DSCIMConfig:
    """Paper's precise variant: 8x OR-MAC16 per 128-row column."""
    return DSCIMConfig(k=2, length=length, name=f"DS-CIM1/L{length}", **kw)


def dscim2(length: int = 64, **kw) -> DSCIMConfig:
    """Paper's efficient variant: 2x OR-MAC64 per 128-row column."""
    return DSCIMConfig(k=3, length=length, name=f"DS-CIM2/L{length}", **kw)


class DSCIMMacro:
    """Point sequence + count LUT of one macro, with the LUT-gather oracle.

    ``counts_lut`` is the bit-exact reference the fused estimator is held
    to: C[m,n] = Σ_h LUT[h mod G, a[m,h], b[h,n]].  It materializes an
    (M, K, N) gather, so it is for test-sized operands only."""

    def __init__(self, cfg: DSCIMConfig):
        self.cfg = cfg
        self.u, self.v = prng.make_points(
            cfg.points, cfg.length, cfg.seed_u, cfg.seed_v,
            cfg.param_u, cfg.param_v)
        self.lut_np = build_count_lut(self.u, self.v, cfg.k)   # (G, S, S)

    def _shift(self, x_i8, w_i8):
        k = self.cfg.k
        return ((x_i8.to(torch.int32) + 128) >> k,
                (w_i8.to(torch.int32) + 128) >> k)

    def counts_lut(self, x_i8: torch.Tensor, w_i8: torch.Tensor
                   ) -> torch.Tensor:
        """(M, K) int8, (K, N) int8 -> (M, N) int32 OR-accumulated counts."""
        a, b = self._shift(x_i8, w_i8)
        K = a.shape[-1]
        lut = torch.as_tensor(self.lut_np, device=a.device)
        blk = torch.arange(K, device=a.device) % self.cfg.group
        g = lut[blk[None, :, None], a[:, :, None].long(),
                b[None, :, :].long()]                   # (M, K, N)
        return g.sum(dim=1, dtype=torch.int64).to(torch.int32)

    def mvm_from_counts(self, x_i8, w_i8, counts) -> torch.Tensor:
        """psum estimate (M, N) f32 from a count matrix, with the exact
        correction terms (and the center-truncation terms when set)."""
        cfg = self.cfg
        a, b = self._shift(x_i8, w_i8)
        x32 = x_i8.to(torch.int32)
        w32 = w_i8.to(torch.int32)
        out = cfg.scale * counts.to(torch.float32)
        term_c = 128.0 * x32.sum(-1, keepdim=True).to(torch.float32)
        term_d = 128.0 * (w32 + 128).sum(0, keepdim=True).to(torch.float32)
        corr = -term_c - term_d
        if cfg.trunc == "center":
            delta = (2 ** cfg.k - 1) / 2.0
            K = x_i8.shape[-1]
            corr = corr + (2 ** cfg.k) * delta * (
                a.sum(-1, keepdim=True) + b.sum(0, keepdim=True)
            ).to(torch.float32) + K * delta * delta
        return out + corr
