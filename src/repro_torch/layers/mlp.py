"""Feed-forward blocks, SwiGLU (llama/qwen family) and the non-gated GELU
MLP (starcoder2, musicgen), with an optional DS-CIM linear (port of
``repro/layers/mlp.py``).  Weights may be float matrices or prepared
``QuantizedLinearWeight``s; the latter need a DS-CIM ``linear``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.qweights import QuantizedLinearWeight

__all__ = ["mlp"]


def mlp(params, x: torch.Tensor, kind: str = "swiglu", linear=None,
        salt=None) -> torch.Tensor:
    """linear: optional callable (x, w, salt=...) -> y (e.g. DSCIMLinear),
    whose f32 output is cast back to the activation dtype.  ``salt``: the
    layer's base salt; the three matmul sites fold in offsets 0..2 (the
    noise modes' call-site key, as in the reference)."""
    def mm(a, w, site):
        if linear is None:
            if isinstance(w, QuantizedLinearWeight):
                raise TypeError("prepared (QuantizedLinearWeight) params "
                                "need a DS-CIM `linear` operator")
            return a @ w
        s = None if salt is None else salt + site
        return linear(a, w, salt=s).to(a.dtype)

    if kind == "swiglu":
        h = F.silu(mm(x, params["w_gate"], 0)) * mm(x, params["w_up"], 1)
    elif kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(mm(x, params["w_up"], 1), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return mm(h, params["w_down"], 2)
