"""Prepared (quantize-once) DS-CIM linear weights (port of
``repro/core/qweights.py``).

A ``QuantizedLinearWeight`` holds the window-packed int8 planes and
per-window dequant scales a DS-CIM chip keeps resident:

* ``q``     — int8 ``(*stack, nw, g, N)`` window planes (``stack`` carries
              the stacked layer dim);
* ``scale`` — f32 ``(*stack, nw, N)`` per-window dequant scales;
* ``k_orig``/``group_k`` — the unpadded contraction length and the
              requested window granularity.
"""
from __future__ import annotations

import dataclasses

import torch

from .quant import quantize_int8

__all__ = ["QuantizedLinearWeight", "prepare_linear_weight",
           "prepare_dscim_params", "split_dscim_mode", "map_params",
           "ELIGIBLE_PATTERNS", "ATTN_PATTERNS"]


@dataclasses.dataclass
class QuantizedLinearWeight:
    q: torch.Tensor        # int8 (*stack, nw, g, N)
    scale: torch.Tensor    # f32  (*stack, nw, N)
    k_orig: int
    group_k: int | None

    @property
    def nw(self) -> int:
        return self.q.shape[-3]

    @property
    def g(self) -> int:
        return self.q.shape[-2]

    @property
    def n(self) -> int:
        return self.q.shape[-1]

    @property
    def stack(self) -> tuple:
        return tuple(self.q.shape[:-3])

    @property
    def shape(self) -> tuple:
        return (*self.stack, self.k_orig, self.n)

    def __getitem__(self, i) -> "QuantizedLinearWeight":
        """Slice the stack dims (one layer of a stacked weight)."""
        return QuantizedLinearWeight(self.q[i], self.scale[i], self.k_orig,
                                     self.group_k)


def prepare_linear_weight(w: torch.Tensor, group_k: int | None = 128
                          ) -> QuantizedLinearWeight:
    """Float ``(*stack, K, N)`` -> prepared weight (quantize once): K is
    padded with float zeros to whole ``group_k`` windows *before*
    quantizing, one symmetric int8 scale per (window, column)."""
    *stack, K, N = w.shape
    g = group_k or K
    pad = (-K) % g
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    nw = (K + pad) // g
    qt = quantize_int8(w.reshape(*stack, nw, g, N), axis=-2)
    # contiguous planes: a transposed source (the tied head's embed.T)
    # would otherwise leave them strided, and the kernel reads them dense
    return QuantizedLinearWeight(
        qt.q.contiguous(),
        qt.scale.reshape(*stack, nw, N).to(torch.float32).contiguous(),
        K, group_k)


# Name patterns ('a/b/c' paths) of the matrices the DS-CIM serving path
# routes through DSCIMLinear: the MLP matmuls and the LM head.  Attention
# projections are exact unless the spec carries '+attn'.
ELIGIBLE_PATTERNS = (
    "mlp/w_up", "mlp/w_gate", "mlp/w_down",
    "moe/shared/w_up", "moe/shared/w_gate", "moe/shared/w_down",
    "lm_head",
)
ATTN_PATTERNS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")


def split_dscim_mode(spec: str) -> tuple[str, bool]:
    """dscim spec -> (base mode, attn opt-in): 'kernel+attn:...' ->
    ('kernel', True); 'off' -> ('off', False)."""
    mode = spec.split(":")[0]
    if mode.endswith("+attn"):
        return mode[:-len("+attn")], True
    return mode, False


def map_params(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict of tensors
    (``QuantizedLinearWeight`` is a leaf); returns a new tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def prepare_dscim_params(params, cfg, *, group_k: int | None = 128):
    """Convert every DS-CIM-eligible matrix of ``params`` once (serve
    startup); returns a new tree, float originals dropped.  Tied models
    have no ``lm_head``, so a prepared head is materialized from
    ``embed.T`` (the embedding stays float for the lookup).  A '+attn'
    spec adds the attention projections; 'off'/'float' return ``params``."""
    mode, attn = split_dscim_mode(cfg.dscim)
    if mode in ("off", "float"):
        return params
    pats = ELIGIBLE_PATTERNS + (ATTN_PATTERNS if attn else ())

    def assign(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and any(t in path for t in pats)):
            return prepare_linear_weight(leaf, group_k)
        return leaf

    out = map_params(assign, params)
    if cfg.tie_embeddings and not cfg.stub_frontend and "lm_head" not in out:
        out["lm_head"] = prepare_linear_weight(params["embed"].T, group_k)
    return out
