"""Calibrated statistical DS-CIM error injection (port of
``repro/core/error_model.py``).

The exact backends (``lut``/``bitmatmul``) emulate the macro bit-exactly;
the noise backends instead add a Gaussian error whose moments are
*measured from the exact LUT process* (the paper evaluates networks by
"adding the DS-CIM error pattern to the MVM results", Sec. V).

Per-row error moments (mu1, sig1) are estimated once per macro config by
Monte-Carlo over the data distribution, with numpy exactly as the
reference does (one seed gives the same moments to float64 equality); a
K-row accumulation then has mean K*mu1 and std sqrt(K)*sig1.

The reference draws the noise with ``jax.random``; here it comes from
``core/counter_rng.normals``: a pure function of an integer key and the
element index (no cross-framework bitwise contract for the noise itself,
only its moments).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .counter_rng import normals
from .macro import DSCIMMacro

__all__ = ["ErrorModel"]


@dataclasses.dataclass(frozen=True)
class ErrorModel:
    mu1: float      # mean per-row psum error (int units)
    sig1: float     # std per-row psum error
    name: str = "dscim-errmodel"

    @staticmethod
    def from_macro(macro: DSCIMMacro, n_samples: int = 200_000,
                   seed: int = 0, dist: str = "uniform") -> "ErrorModel":
        """Measure per-row error moments of scale*count(a,w) - x*w + corr."""
        cfg = macro.cfg
        rng = np.random.default_rng(seed)
        if dist == "uniform":
            x = rng.integers(-128, 128, n_samples).astype(np.int64)
            w = rng.integers(-128, 128, n_samples).astype(np.int64)
        elif dist == "gaussian":
            x = np.clip(np.round(rng.normal(0, 42, n_samples)), -128,
                        127).astype(np.int64)
            w = np.clip(np.round(rng.normal(0, 42, n_samples)), -128,
                        127).astype(np.int64)
        else:
            raise ValueError(dist)
        k = cfg.k
        a = (x + 128) >> k
        b = (w + 128) >> k
        g = rng.integers(0, cfg.group, n_samples)
        counts = macro.lut_np[g, a, b].astype(np.float64)
        est = cfg.scale * counts - 128.0 * x - 128.0 * (w + 128)
        if cfg.trunc == "center":
            delta = (2 ** k - 1) / 2.0
            est = est + (2 ** k) * delta * (a + b) + delta * delta
        err = est - (x * w).astype(np.float64)
        return ErrorModel(float(err.mean()), float(err.std()),
                          name=f"errmodel[{cfg.name}]")

    def inject(self, exact_psum: torch.Tensor, key: int, k_dim: int
               ) -> torch.Tensor:
        """Physical model: k_dim-row accumulation, error mean and variance
        scaling with K.  exact_psum: (..., N) float accumulations over
        k_dim rows; ``key`` names the draw (``counter_rng.normals``)."""
        return exact_psum + self.psum_noise(key, exact_psum.shape, k_dim,
                                            exact_psum.device)

    def psum_noise(self, key: int, shape, k_dim: int, device
                   ) -> torch.Tensor:
        """``inject``'s additive term of ``shape``: mean ``mu1 * k_dim``,
        std ``sqrt(k_dim) * sig1``, drawn from ``key``.  A constant to
        autograd: the noise modes' gradient reaches x and w only through
        the dequant scales it is multiplied by."""
        z = normals(key, shape, device)
        return self.mu1 * k_dim + float(np.sqrt(self.sig1 ** 2 * k_dim)) * z

    def relative_moment_bound(self, rows: int = 128) -> float:
        """Expected *relative* per-output psum error of one ``rows``-row
        accumulation window: |bias| + 1-sigma of the window error,
        ``|mu1|*rows + sqrt(rows)*sig1``, over the typical magnitude of
        an exact ``rows``-row int8 psum under the calibration
        distribution, ``sqrt(rows) * E|x*w|`` with x, w ~ U[-128, 128)
        (E|xw| = 64^2).  The serving accuracy watchdog turns it into a
        logit-drift threshold."""
        err = abs(self.mu1) * rows + np.sqrt(rows) * self.sig1
        signal = np.sqrt(rows) * 64.0 * 64.0
        return float(err / signal)

    def inject_paper(self, exact_psum: torch.Tensor, key: int,
                     window: int = 128) -> torch.Tensor:
        """Paper-style injection (Sec. V): one window-magnitude error per
        *output*, independent of how many 128-row windows the K dim
        spans."""
        z = normals(key, exact_psum.shape, exact_psum.device)
        return exact_psum + (self.mu1 * window
                             + self.sig1 * float(np.sqrt(window)) * z)
