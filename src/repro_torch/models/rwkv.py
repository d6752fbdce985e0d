"""RWKV6 "Finch" LM, the ssm family (port of ``repro/models/rwkv.py``):
rwkv6-7b, attention-free, O(1)-state decode.

The API is ``models/lm.py``'s (``init_params``, ``cast_layers``,
``forward``, ``prefill``, ``decode``) plus ``cache_specs``.  The "cache"
is the per-layer recurrent state, stacked on axis 0 (token-shift tails
and WKV matrices), whose size does not depend on the sequence length.
The model is served in float only: the reference prepares no DS-CIM
weights for this family and pages no cache.

Under a mesh (``par``, a ``parallel.ParallelCtx``, to ``forward``,
``prefill`` and ``decode``): every float leaf is gathered whole before
use (ZeRO-3) and each layer's WKV scan runs on this rank's heads and
rows (layers/rwkv6.py); the state's WKV matrices are this rank's piece
(``cache_specs(par=)``, launch/sharding.py's rule), the token-shift
tails whole.  Inputs and logits are whole on every rank.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..layers.norms import rmsnorm
from ..layers.remat import remat
from ..layers.rwkv6 import LORA_R, init_rwkv6_state, rwkv6_block
from .lm import (DTYPES, _cast, _embed_prompt, _full, _layer, _whole, embed,
                 generator, unstack)

__all__ = ["init_params", "cast_layers", "forward", "prefill", "decode",
           "cache_specs"]


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random f32 parameters in the reference's layout and scales
    (``init_rwkv6`` per layer, stacked on axis 0), drawn from a
    ``torch.Generator`` seeded with ``seed``.  The reference draws
    ``wr_ffn`` from the key it draws ``wr`` from, so the two are equal
    there; here ``wr_ffn`` is a copy of ``wr`` for the same function."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    L, D, Fd, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
    H = D // hd
    s = D ** -0.5

    def randn(*shape, std=s):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    def full(*shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def norm(*lead):
        return {"scale": full(*lead, D, value=1.0)}

    layers = {
        "mu": full(L, 5, D, value=0.5),        # w,k,v,r,g base lerp
        "maa_w1": randn(L, D, 5 * LORA_R),
        "maa_w2": randn(L, 5, LORA_R, D, std=LORA_R ** -0.5),
        "decay_base": full(L, D, value=-1.5),
        "decay_w1": randn(L, D, 2 * LORA_R),
        "decay_w2": randn(L, 2 * LORA_R, D, std=(2 * LORA_R) ** -0.5),
        "wr": randn(L, D, D), "wk": randn(L, D, D), "wv": randn(L, D, D),
        "wg": randn(L, D, D), "wo": randn(L, D, D),
        "u": randn(L, H, hd, std=0.3),         # per-head bonus
        "ln_x": norm(L), "ln1": norm(L), "ln2": norm(L),
        "mu_ffn": full(L, 2, D, value=0.5),
        "wk_ffn": randn(L, D, Fd),
        "wv_ffn": randn(L, Fd, D, std=Fd ** -0.5),
    }
    layers["wr_ffn"] = layers["wr"].clone()
    return {"embed": randn(cfg.vocab_padded, D, std=0.02),
            "layers": layers, "ln_in": norm(), "final_norm": norm(),
            "lm_head": randn(D, cfg.vocab_padded)}


def cast_layers(params, dtype: torch.dtype):
    """Every layer leaf and the head in the compute dtype, once (the
    reference casts them on every call; the bits are the same)."""
    return dict(params, layers=_cast(params["layers"], dtype),
                lm_head=params["lm_head"].to(dtype))


def _head(params, cfg: ArchConfig, x, par=None):
    """Final norm and head of (B, 1, D) -> (B, Vp) f32."""
    x = rmsnorm(x, params["final_norm"])
    return (x @ _full(params["lm_head"], par).to(x.dtype)).to(
        torch.float32)[:, 0]


def cache_specs(cfg: ArchConfig, batch: int, seq: int, device="meta",
                par=None):
    """The serving state of ``batch`` rows, whatever ``seq``: the
    reference's shapes and dtypes as zero tensors on ``device`` (``meta``:
    shapes and dtypes only); under the mesh ``par`` the WKV matrices are
    this rank's piece."""
    L = cfg.n_layers
    one = init_rwkv6_state(batch, cfg.d_model, cfg.ssm_head_dim,
                           device=device, par=par)
    return {"states": {k: torch.zeros((L, *v.shape), dtype=v.dtype,
                                      device=device)
                       for k, v in one.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _train_layer(cfg: ArchConfig, par, zero, x, lp):
    """One layer of ``forward`` from the zero state (its weights cast to
    the compute dtype inside the rematerialized body)."""
    return rwkv6_block(_cast(lp, x.dtype), x, zero, cfg.ssm_head_dim,
                       cfg.scan_chunk, par)[0]


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, par=None):
    """Training and scoring forward: tokens (B, S), S a multiple of
    ``scan_chunk`` or shorter -> (logits (B, S, Vp) f32, aux 0), every
    layer from the zero state, rematerialized in the backward pass when
    ``cfg.remat``.  Out of place (prefill and decode are the serving
    paths, which write the state).  ``par``: the train step's view of
    its mesh (whole leaves; each layer's scan on this rank's heads)."""
    dt = DTYPES[cfg.compute_dtype]
    x = rmsnorm(embed(params, tokens).to(dt), params["ln_in"])
    B, _, D = x.shape
    zero = init_rwkv6_state(B, D, cfg.ssm_head_dim, device=x.device,
                            par=par)
    for lp in unstack(params["layers"], cfg.n_layers):
        x = remat(_train_layer, cfg, par, zero, x, lp, on=cfg.remat)
    x = rmsnorm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(dt)).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            capacity: int | None = None, par=None):
    """Forward over the prompt (B, S), S a multiple of ``scan_chunk`` or
    shorter -> (last-token logits (B, Vp) f32, {"states": the layers'
    states stacked on axis 0, "pos": S}).  ``capacity`` has no effect:
    the state does not depend on the sequence length.  ``par``: under
    that mesh (module docstring)."""
    dt = DTYPES[cfg.compute_dtype]
    x = rmsnorm(_embed_prompt(params, tokens, par).to(dt), params["ln_in"])
    B, S, D = x.shape
    zero = init_rwkv6_state(B, D, cfg.ssm_head_dim, device=x.device,
                            par=par)
    states = []
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        x, st = rwkv6_block(lp, x, zero, cfg.ssm_head_dim, cfg.scan_chunk,
                            par)
        states.append(st)
    stacked = {k: torch.stack([st[k] for st in states]) for k in zero}
    pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _head(params, cfg, x[:, -1:], par), {"states": stacked,
                                                "pos": pos}


@torch.no_grad()
def decode(params, cfg: ArchConfig, token: torch.Tensor, cache,
           done: torch.Tensor | None = None, par=None):
    """One-token decode, token (B,) -> (logits (B, Vp) f32, cache).  The
    state tensors and ``pos`` are updated in place, so the step can be
    captured in a CUDA graph.  ``done`` is ignored, as the reference's
    state update ignores it: a finished row's state moves on, and its
    tokens are ``PAD_ID`` whatever it holds.  ``par``: under that mesh."""
    dt = DTYPES[cfg.compute_dtype]
    x = rmsnorm(_full(params["embed"], par)[token][:, None].to(dt),
                params["ln_in"])
    states = cache["states"]
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        st = {k: v[li] for k, v in states.items()}
        x, new = rwkv6_block(lp, x, st, cfg.ssm_head_dim, chunk=1, par=par)
        for k, v in new.items():
            st[k].copy_(v)
    cache["pos"].add_(1)
    return _head(params, cfg, x, par), cache
