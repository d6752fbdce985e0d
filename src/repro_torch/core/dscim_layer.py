"""DSCIMLinear: a drop-in replacement for ``x @ W`` that quantizes to int8
and computes the product the way a DS-CIM macro would (port of
``repro/core/dscim_layer.py``, all seven modes).

* ``float``        — plain ``x @ w`` (no quantization);
* ``exact``        — int8 product, float rescale (the DCIM adder-tree
                     baseline);
* ``lut``          — bit-exact DS-CIM emulation via the joint-count LUT
                     oracle (test-sized operands);
* ``bitmatmul``    — bit-exact DS-CIM through the count kernel
                     (``kernels/dscim_mvm.py dscim_counts``: the CUDA
                     kernel on the card, one launch a window, and its
                     plain {0,1} bit-expansion version on the CPU);
                     bitwise equal to ``lut``;
* ``kernel``       — the serving hot path: the fused DS-CIM MVM
                     (kernels/dscim_fused.py), a hand-written CUDA kernel
                     on the card and its plain version on the CPU;
* ``statistical``  — the exact int8 psum of each window plus Gaussian
                     error with the macro's measured moments
                     (``core/error_model.py``), scaled by the window's K;
* ``paper_inject`` — the exact product plus one window-magnitude error per
                     output (the paper's Sec. V convention).

Every mode but ``float`` takes ``w`` as a float ``(K, N)`` matrix
(quantized per call) or a prepared ``QuantizedLinearWeight``; the two are
bit-identical.  K is split into ``group_k`` windows with their own int8
scales, stochastic within a window and summed exactly across windows.

Noise keys (``statistical`` / ``paper_inject``): the noise is a pure
function of (``seed``, K, N, the call-site ``salt``, element index)
(``core/counter_rng.normals``), so distinct layers and matmul sites draw
distinct noise, one call site draws the same noise at every call (as the
reference's fallback key does), and a CUDA graph replays it with no
generator state.  ``salt=None`` folds no salt, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .counter_rng import fold
from .error_model import ErrorModel
from .macro import DSCIMConfig, DSCIMMacro
from .qweights import QuantizedLinearWeight, prepare_linear_weight
from .quant import quantize_int8
from .seed_search import calibrated_config

__all__ = ["DSCIMLinear", "make_linear", "MODES"]

Mode = Literal["float", "exact", "lut", "bitmatmul", "kernel", "statistical",
               "paper_inject"]
MODES = ("float", "exact", "lut", "bitmatmul", "kernel", "statistical",
         "paper_inject")
# modes whose output rows each depend on their own input row only, bit for
# bit: integer psums (exact, LUT and kernel counts) and an elementwise
# dequant.  ``models/lm.py decode_multi`` batches these over a speculative
# window; the others (a float matmul, noise drawn per element index) run
# at the decode's shape there.
BATCH_INVARIANT = ("exact", "lut", "bitmatmul", "kernel")


@dataclasses.dataclass
class DSCIMLinear:
    cfg: DSCIMConfig
    mode: Mode = "lut"
    group_k: int | None = 128
    seed: int = 0                   # base of the noise key
    # the mesh a serving run is placed on (parallel.ParallelCtx), or None:
    # 'kernel' routes through the sharded fused MVM, the other modes make
    # a rank's N-slice of a prepared weight whole first
    par: object = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unsupported DSCIMLinear mode {self.mode!r}")
        self.macro = DSCIMMacro(self.cfg)
        self._errmodel = (ErrorModel.from_macro(self.macro)
                          if self.mode in ("statistical", "paper_inject")
                          else None)

    @property
    def batch_invariant(self) -> bool:
        """Whether each output row's bits depend on its input row only."""
        return self.mode in BATCH_INVARIANT

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

    def _resolve_key(self, salt, K: int, N: int) -> int:
        """The noise key: ``seed`` folded with the operand shape and, where
        given, the call-site salt."""
        if salt is None:
            return fold(self.seed, K, N)
        return fold(self.seed, K, N, salt)

    def _psums(self, x2, w2, nw: int, g: int) -> torch.Tensor:
        """Per-window psums (M, nw, N) f32 of int8 x2 (M,nw,g), w2
        (nw,g,N)."""
        if self.mode in ("exact", "statistical", "paper_inject"):
            # int8 x int8 sums are exact in f64 (and in f32 below 2^24)
            return torch.einsum("mug,ugn->mun", x2.double(),
                                w2.double()).to(torch.float32)
        if self.mode == "lut":
            counts = [self.macro.counts_lut(x2[:, u], w2[u])
                      for u in range(nw)]
        else:                                          # bitmatmul
            counts = [self.macro.counts_kernel(x2[:, u].contiguous(), w2[u])
                      for u in range(nw)]
        return torch.stack([self.macro.mvm_from_counts(x2[:, u], w2[u], c)
                            for u, c in enumerate(counts)], dim=1)

    def __call__(self, x: torch.Tensor, w, *, salt=None) -> torch.Tensor:
        """x (..., K) float; w (K, N) float or QuantizedLinearWeight ->
        (..., N) float32.  ``salt``: the call site's int, folded into the
        noise key of the noise modes (ignored by the others)."""
        if self.par is not None:
            from ..parallel import Sharded
            if self.mode == "kernel":
                from ..kernels.dscim_fused import dscim_fused_mvm_sharded
                qw = w.local if isinstance(w, Sharded) else w
                if not isinstance(qw, QuantizedLinearWeight):
                    w = qw = prepare_linear_weight(w, self.group_k)
                self._check_prepared(x, qw)
                return dscim_fused_mvm_sharded(
                    x, w, self.cfg, self.par, batch_axes=self.par.dp_axes)
            w = self.par.whole_qweight(w)
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
        sx = xq.scale.reshape(-1, nw)
        psum = self._psums(xq.q, w2, nw, g)
        if self.mode == "statistical":
            psum = self._errmodel.inject(psum, self._resolve_key(salt, K, N),
                                         g)
        # dequant and window sum as elementwise ops in window order: each
        # output row depends on its own row only, on any device
        out = psum[:, 0] * (sx[:, 0, None] * wscale[0])
        for u in range(1, nw):
            out = out + psum[:, u] * (sx[:, u, None] * wscale[u])
        if self.mode == "paper_inject":
            # Sec. V convention: one 128-row-window error magnitude added
            # per *output* of the MVM result, in float units of the mean
            # window scale
            s = sx.mean(1, keepdim=True) * wscale.mean(0, keepdim=True)
            noise = self._errmodel.inject_paper(
                torch.zeros_like(out), self._resolve_key(salt, K, N),
                self.macro.cfg.rows)
            out = out + noise * s
        return out.reshape(*lead, N).to(torch.float32)


def make_linear(variant: str = "dscim1", length: int = 256,
                mode: Mode = "lut", calib: str = "paper", *,
                par=None) -> DSCIMLinear:
    """Calibrated DS-CIM1/2 linear ('paper' or 'opt' point sets); ``par``
    places it on a mesh (``DSCIMLinear.par``)."""
    if variant not in ("dscim1", "dscim2"):
        raise ValueError(variant)
    return DSCIMLinear(calibrated_config(variant, length, calib), mode,
                       par=par)

