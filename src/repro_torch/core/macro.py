"""DS-CIM macro model (port of ``repro/core/macro.py``): the static macro
configuration plus the MVM estimator with its count backends.

``psum_hat = scale * C  -  128*Σx  -  128*Σw'``        (Eq. 4)

where ``C`` is the OR-accumulated count over L cycles and ``scale =
4^k * 2^16 / L``.  DS-CIM1 = OR-MAC16 (k=2), DS-CIM2 = OR-MAC64 (k=3).
Count backends:

* ``lut``       — joint-count LUT gather, the bit-exact oracle;
* ``bitmatmul`` — the {0,1} bitstream-expansion matmul over all L points
                  (the plain version of the count kernel,
                  ``kernels/dscim_mvm.py dscim_counts_plain``);
* ``kernel``    — ``kernels/dscim_mvm.py dscim_counts``: the CUDA count
                  kernel on CUDA tensors, its plain version on CPU tensors;
* ``cycle``     — the cycle-level OR-MAC (``core/ormac.py``), the hardware
                  oracle the others are held to (test-sized operands).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.dscim_mvm import dscim_counts, dscim_counts_plain
from . import ormac, prng
from .remap import build_count_lut, fold, group_size, shifted_bits

__all__ = ["DSCIMConfig", "DSCIMMacro", "dscim1", "dscim2", "rmse_operands"]

Backend = Literal["lut", "bitmatmul", "kernel", "cycle"]


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


def rmse_operands(rows: int, n_cols: int, n_vec: int, seed: int,
                  dist: str):
    """The Monte-Carlo operands of ``DSCIMMacro.rmse``: x (n_vec, rows) and
    w (rows, n_cols) int64 int8 values, drawn with numpy exactly as the
    reference draws them, so one seed gives the same operands."""
    rng = np.random.default_rng(seed)
    H = rows
    if dist == "uniform":
        x = rng.integers(-128, 128, (n_vec, H), dtype=np.int64)
        w = rng.integers(-128, 128, (H, n_cols), dtype=np.int64)
    elif dist == "gaussian":
        x = np.clip(np.round(rng.normal(0, 42, (n_vec, H))), -128,
                    127).astype(np.int64)
        w = np.clip(np.round(rng.normal(0, 42, (H, n_cols))), -128,
                    127).astype(np.int64)
    elif dist == "sparse":
        x = rng.integers(-128, 128, (n_vec, H), dtype=np.int64)
        x *= rng.random((n_vec, H)) < 0.25
        w = rng.integers(-128, 128, (H, n_cols), dtype=np.int64)
    else:
        raise ValueError(dist)
    return x, w


class DSCIMMacro:
    """Point sequence + count LUT of one macro, with the count backends and
    the MVM estimate.

    ``counts_lut`` is the bit-exact reference the kernels are held to:
    C[m,n] = Σ_h LUT[h mod G, a[m,h], b[h,n]].  It materializes an
    (M, K, N) gather, so it is for test-sized operands only."""

    def __init__(self, cfg: DSCIMConfig):
        self.cfg = cfg
        self.u, self.v = prng.make_points(
            cfg.points, cfg.length, cfg.seed_u, cfg.seed_v,
            cfg.param_u, cfg.param_v)
        self.lut_np = build_count_lut(self.u, self.v, cfg.k)   # (G, S, S)
        cu, lu = fold(self.u.astype(np.int32), cfg.k)
        cv, lv = fold(self.v.astype(np.int32), cfg.k)
        self.folded = tuple(torch.as_tensor(t, dtype=torch.int32)
                            for t in (cu, lu, cv, lv))
        self._luts: dict = {}

    def lut_table(self, device) -> torch.Tensor:
        """The count LUT on ``device``, copied there once.  The copy is
        from pageable host memory, which a CUDA graph capture forbids: the
        capture preparation (``launch/steps.py _prepare_fn``) makes it
        first, and a first copy during capture raises."""
        device = torch.device(device)
        lut = self._luts.get(device)
        if lut is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.cfg.name}: count LUT copied to "
                                   f"{device} during a CUDA graph capture; "
                                   "make it before capture")
            lut = torch.as_tensor(self.lut_np, device=device)
            self._luts[device] = lut
        return lut

    def _shift(self, x_i8, w_i8):
        k = self.cfg.k
        return ((x_i8.to(torch.int32) + 128) >> k,
                (w_i8.to(torch.int32) + 128) >> k)

    def counts_lut(self, x_i8: torch.Tensor, w_i8: torch.Tensor
                   ) -> torch.Tensor:
        """(M, K) int8, (K, N) int8 -> (M, N) int32 OR-accumulated counts."""
        a, b = self._shift(x_i8, w_i8)
        K = a.shape[-1]
        lut = self.lut_table(a.device)
        blk = torch.arange(K, device=a.device) % self.cfg.group
        g = lut[blk[None, :, None], a[:, :, None].long(),
                b[None, :, :].long()]                   # (M, K, N)
        return g.sum(dim=1, dtype=torch.int64).to(torch.int32)

    def counts_bitmatmul(self, x_i8: torch.Tensor, w_i8: torch.Tensor
                         ) -> torch.Tensor:
        """C = A'W' over {0,1} bitstreams of all L points -> (M, N) int32:
        the plain version of the count kernel on the macro's points."""
        counts = dscim_counts_plain(x_i8, w_i8, *self.folded, self.cfg.k)
        return counts.to(torch.int32)

    def counts_kernel(self, x_i8: torch.Tensor, w_i8: torch.Tensor
                      ) -> torch.Tensor:
        """The count kernel's counts (M, N) f32 on the macro's points
        (``kernels/dscim_mvm.py dscim_counts``: the CUDA kernel on the
        card, its plain version on the CPU)."""
        return dscim_counts(x_i8, w_i8, *self.folded, k=self.cfg.k,
                            length=self.cfg.length)

    def counts_cycle(self, x_i8: torch.Tensor, w_i8: torch.Tensor
                     ) -> torch.Tensor:
        """The cycle-level OR-MAC's counts (M, N) int64, each OR group
        checked collision-free (``core/ormac.py dscim_counts_cycle``):
        small shapes only, K a whole number of OR groups."""
        a, b = self._shift(torch.as_tensor(x_i8), torch.as_tensor(w_i8))
        return ormac.dscim_counts_cycle(a, b, self.u, self.v, self.cfg.k,
                                        assert_disjoint=True)

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

    def mvm(self, x_i8: torch.Tensor, w_i8: torch.Tensor,
            backend: Backend = "lut") -> torch.Tensor:
        """DS-CIM estimate (M, N) f32 of x_i8 @ w_i8 (int8 values)."""
        if backend == "lut":
            counts = self.counts_lut(x_i8, w_i8)
        elif backend == "bitmatmul":
            counts = self.counts_bitmatmul(x_i8, w_i8)
        elif backend == "kernel":
            counts = self.counts_kernel(x_i8, w_i8)
        elif backend == "cycle":
            counts = self.counts_cycle(x_i8, w_i8)
        else:
            raise ValueError(backend)
        return self.mvm_from_counts(x_i8, w_i8, counts)

    def rmse(self, n_cols: int = 512, n_vec: int = 64, seed: int = 0,
             dist: str = "uniform", backend: Backend = "lut",
             device=None) -> dict:
        """Monte-Carlo RMSE of the H-row MAC vs the exact int8 matmul, with
        the reference's operands (``rmse_operands``) and normalizations
        (signed fullscale H*128*128, unsigned fullscale H*255*255).  Runs
        on ``device`` (CUDA unless the CPU is asked for)."""
        dev = resolve_device(device)
        H = self.cfg.rows
        x, w = rmse_operands(H, n_cols, n_vec, seed, dist)
        exact = x @ w
        est = self.mvm(torch.as_tensor(x, dtype=torch.int32, device=dev),
                       torch.as_tensor(w, dtype=torch.int32, device=dev),
                       backend).cpu().numpy()
        err = est - exact
        rms = float(np.sqrt(np.mean(err ** 2)))
        return {
            "rms_abs": rms,
            "bias": float(err.mean()),
            "signed_fullscale": 100.0 * rms / (H * 128 * 128),
            "unsigned_fullscale": 100.0 * rms / (H * 255 * 255),
        }
