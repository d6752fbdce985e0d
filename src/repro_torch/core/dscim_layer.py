"""DSCIMLinear: a drop-in replacement for ``x @ W`` that quantizes to int8
and computes the product the way a DS-CIM macro would (port of
``repro/core/dscim_layer.py``, modes ``float``, ``exact``, ``lut`` and
``kernel``).

* ``float``  — plain ``x @ w`` (no quantization);
* ``exact``  — int8 product, float rescale (the DCIM adder-tree baseline);
* ``lut``    — bit-exact DS-CIM emulation via the joint-count LUT oracle
               (test-sized operands);
* ``kernel`` — the serving hot path: the fused DS-CIM MVM
               (kernels/dscim_fused.py), a hand-written CUDA kernel on the
               card and its plain version on the CPU.

Every mode but ``float`` takes ``w`` as a float ``(K, N)`` matrix
(quantized per call) or a prepared ``QuantizedLinearWeight``; the two are
bit-identical.  K is split into ``group_k`` windows with their own int8
scales, stochastic within a window and summed exactly across windows.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .macro import DSCIMConfig, DSCIMMacro
from .qweights import QuantizedLinearWeight
from .quant import quantize_int8
from .seed_search import calibrated_config

__all__ = ["DSCIMLinear", "make_linear"]

Mode = Literal["float", "exact", "lut", "kernel"]


@dataclasses.dataclass
class DSCIMLinear:
    cfg: DSCIMConfig
    mode: Mode = "lut"
    group_k: int | None = 128

    def __post_init__(self):
        if self.mode not in ("float", "exact", "lut", "kernel"):
            raise ValueError(f"unsupported DSCIMLinear mode {self.mode!r}")
        self.macro = DSCIMMacro(self.cfg)

    def _windowed(self, x2, w2):
        """Split K into group_k windows -> (x3 (M,nw,g), w3 (nw,g,N))."""
        M, K = x2.shape
        g = self.group_k or K
        pad = (-K) % g
        if pad:
            x2 = torch.nn.functional.pad(x2, (0, pad))
            w2 = torch.nn.functional.pad(w2, (0, 0, 0, pad))
        nw = x2.shape[1] // g
        return x2.reshape(M, nw, g), w2.reshape(nw, g, -1), nw, g

    def _check_prepared(self, x, qw: QuantizedLinearWeight):
        K = x.shape[-1]
        if qw.k_orig != K:
            raise ValueError(f"prepared weight K={qw.k_orig} vs x K={K}")
        g = self.group_k or K
        if qw.g != g:
            raise ValueError(
                f"prepared weight granularity g={qw.g} does not match the "
                f"layer's group_k={self.group_k} (effective g={g})")

    def __call__(self, x: torch.Tensor, w) -> torch.Tensor:
        """x (..., K) float; w (K, N) float or QuantizedLinearWeight ->
        (..., N) float32."""
        prepared = isinstance(w, QuantizedLinearWeight)
        if self.mode == "float":
            if prepared:
                raise TypeError("mode='float' needs float weights")
            return x @ w
        if self.mode == "kernel":
            from ..kernels.dscim_fused import (dscim_fused_mvm,
                                               dscim_fused_mvm_prepared)
            if prepared:
                self._check_prepared(x, w)
                return dscim_fused_mvm_prepared(x, w, self.cfg)
            return dscim_fused_mvm(x, w, self.cfg, group_k=self.group_k)
        lead = x.shape[:-1]
        K = x.shape[-1]
        xf = x.reshape(-1, K)
        if prepared:
            self._check_prepared(x, w)
            nw, g, N = w.nw, w.g, w.n
            pad = nw * g - K
            x3 = torch.nn.functional.pad(xf, (0, pad)) if pad else xf
            x3 = x3.reshape(-1, nw, g)
            w2, wscale = w.q, w.scale
        else:
            N = w.shape[-1]
            x3, w3, nw, g = self._windowed(xf, w)
            wq = quantize_int8(w3, axis=1)
            w2, wscale = wq.q, wq.scale.reshape(nw, N)
        xq = quantize_int8(x3, axis=-1)
        x2 = xq.q
        if self.mode == "exact":
            # int8 x int8 sums are exact in f64 (and in f32 below 2^24)
            psum = torch.einsum("mug,ugn->mun", x2.double(),
                                w2.double()).to(torch.float32)
        else:                                          # lut
            psum = torch.stack([
                self.macro.mvm_from_counts(
                    x2[:, u], w2[u], self.macro.counts_lut(x2[:, u], w2[u]))
                for u in range(nw)], dim=1)            # (M, nw, N)
        out = torch.einsum("mun,mu,un->mn", psum,
                           xq.scale.reshape(-1, nw), wscale)
        return out.reshape(*lead, N).to(torch.float32)


def make_linear(variant: str = "dscim1", length: int = 256,
                mode: Mode = "lut", calib: str = "paper") -> DSCIMLinear:
    """Calibrated DS-CIM1/2 linear ('paper' or 'opt' point sets)."""
    if variant not in ("dscim1", "dscim2"):
        raise ValueError(variant)
    return DSCIMLinear(calibrated_config(variant, length, calib), mode)
