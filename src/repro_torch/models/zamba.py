"""Zamba2 hybrid LM (port of ``repro/models/zamba.py``):
a Mamba2 (SSD) backbone and one *shared* GQA attention block, zamba2-7b.

The n_layers Mamba2 layers form n_blocks = n_layers // mamba_per_block
super-blocks, each [mamba2 x mamba_per_block ; shared attention]: one
weight set (``shared_attn``, ``shared_ln``) serves every application.
Per-block leaves are stacked (n_blocks, mamba_per_block, ...).

The cache is the Mamba2 states (stacked the same way) and one dense K/V
cache per application of the shared block, (n_blocks, B, T, KV, HD);
``pos`` is one position for every row.  The API is ``models/lm.py``'s
(``forward`` included) plus ``cache_specs``.  The model is served in
float only: the reference prepares no DS-CIM weights for this family and
pages no cache.

Under a mesh (``par``, a ``parallel.ParallelCtx``, to ``forward``,
``prefill`` and ``decode``): every float leaf is gathered whole before
use (ZeRO-3), each Mamba2 layer's SSD scan runs on this rank's batch
rows (layers/mamba2.py) and the shared attention runs as the dense
family's does under a mesh (whole weights, the dense K/V caches whole
on every rank).  The Mamba2 h states are this rank's rows
(``cache_specs(par=)``), the conv tails whole.  Inputs and logits are
whole on every rank.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..layers.attention import attention, decode_attention
from ..layers.mamba2 import CONV_K, init_mamba2_state, mamba2_block
from ..layers.norms import rmsnorm
from ..layers.remat import remat
from .lm import (DTYPES, _cast, _embed_prompt, _full, _layer, _whole, embed,
                 generator, unstack)

__all__ = ["init_params", "cast_layers", "forward", "prefill", "decode",
           "cache_specs"]


def _n_blocks(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.mamba_per_block:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of mamba_per_block {cfg.mamba_per_block}")
    return cfg.n_layers // cfg.mamba_per_block


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random f32 parameters in the reference's layout and scales
    (``init_mamba2`` and a norm per layer, stacked (n_blocks,
    mamba_per_block, ...); ``init_attention`` for the shared block),
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    nb, mpb = _n_blocks(cfg), cfg.mamba_per_block
    D, N, hd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    H, KV, HD = cfg.n_heads, cfg.n_kv, cfg.head_dim
    d_in = D                                  # expand 1
    s = D ** -0.5

    def randn(*shape, std=s):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    def full(*shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    lead = (nb, mpb)
    mamba = {
        "wz": randn(*lead, D, d_in), "wx": randn(*lead, D, d_in),
        "wB": randn(*lead, D, N), "wC": randn(*lead, D, N),
        "wdt": randn(*lead, D, d_in // hd),
        "dt_bias": full(*lead, d_in // hd, value=0.0),
        "A_log": full(*lead, d_in // hd, value=0.0),     # A = -exp(A_log)
        "D": full(*lead, d_in // hd, value=1.0),
        "conv": randn(*lead, CONV_K, d_in + 2 * N, std=0.2),
        "norm": {"scale": full(*lead, d_in, value=1.0)},
        "wo": randn(*lead, d_in, D, std=d_in ** -0.5),
    }
    shared = {"wq": randn(D, H * HD), "wk": randn(D, KV * HD),
              "wv": randn(D, KV * HD),
              "wo": randn(H * HD, D, std=(H * HD) ** -0.5)}
    if cfg.qk_norm:
        shared["q_norm"] = {"scale": full(HD, value=1.0)}
        shared["k_norm"] = {"scale": full(HD, value=1.0)}
    return {"embed": randn(cfg.vocab_padded, D, std=0.02),
            "blocks": {"mamba": mamba,
                       "ln": {"scale": full(*lead, D, value=1.0)}},
            "shared_attn": shared,
            "shared_ln": {"scale": full(D, value=1.0)},
            "final_norm": {"scale": full(D, value=1.0)},
            "lm_head": randn(D, cfg.vocab_padded)}


def cast_layers(params, dtype: torch.dtype):
    """The blocks, the shared attention and the head in the compute dtype,
    once (the reference casts them on every call; the bits are the
    same).  ``shared_ln`` stays f32, as the reference leaves it."""
    return dict(params, blocks=_cast(params["blocks"], dtype),
                shared_attn=_cast(params["shared_attn"], dtype),
                lm_head=params["lm_head"].to(dtype))


def _head(params, cfg: ArchConfig, x, par=None):
    """Final norm and head of (B, 1, D) -> (B, Vp) f32."""
    x = rmsnorm(x, params["final_norm"])
    return (x @ _full(params["lm_head"], par).to(x.dtype)).to(
        torch.float32)[:, 0]


def cache_specs(cfg: ArchConfig, batch: int, seq: int, device="meta",
                par=None):
    """The serving cache of ``batch`` rows and ``seq`` positions: the
    reference's shapes and dtypes as zero tensors on ``device``
    (``meta``: shapes and dtypes only); under the mesh ``par`` the h
    states are this rank's rows."""
    nb, mpb = _n_blocks(cfg), cfg.mamba_per_block
    kv = (nb, batch, seq, cfg.n_kv, cfg.head_dim)
    cdt = DTYPES[cfg.cache_dtype]
    one = init_mamba2_state(batch, cfg.d_model, cfg.ssm_head_dim,
                            cfg.ssm_state, device=device, par=par)
    return {"mamba": {k: torch.zeros((nb, mpb, *v.shape), dtype=v.dtype,
                                     device=device)
                      for k, v in one.items()},
            "k": torch.zeros(kv, dtype=cdt, device=device),
            "v": torch.zeros(kv, dtype=cdt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _train_block(cfg: ArchConfig, par, positions, zero, shared, shared_ln,
                 x, blk):
    """One super-block of ``forward``: its Mamba2 layers from the zero
    state, then the shared attention (the block's weights cast to the
    compute dtype inside the rematerialized body)."""
    blk = _cast(blk, x.dtype)
    for lp in unstack(blk, cfg.mamba_per_block):
        h, _ = mamba2_block(lp["mamba"], rmsnorm(x, lp["ln"]), zero,
                            cfg.ssm_head_dim, cfg.scan_chunk, par)
        x = x + h
    h, _ = attention(shared, rmsnorm(x, shared_ln), cfg, positions,
                     cfg.q_chunk)
    return x + h


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, par=None):
    """Training and scoring forward: tokens (B, S) -> (logits (B, S, Vp)
    f32, aux 0), every Mamba2 layer from the zero state, each super-block
    rematerialized in the backward pass when ``cfg.remat``.  Out of place
    (prefill and decode are the serving paths, which write the cache).
    ``par``: the train step's view of its mesh (whole leaves, the batch
    this rank's slice already)."""
    dt = DTYPES[cfg.compute_dtype]
    x = embed(params, tokens).to(dt)
    B, S, D = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    shared = _cast(params["shared_attn"], dt)
    zero = init_mamba2_state(B, D, cfg.ssm_head_dim, cfg.ssm_state,
                             device=x.device, par=par)
    for blk in unstack(params["blocks"], _n_blocks(cfg)):
        x = remat(_train_block, cfg, par, positions, zero, shared,
                  params["shared_ln"], x, blk, on=cfg.remat)
    x = rmsnorm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(dt)).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            capacity: int | None = None, par=None):
    """Forward over the prompt (B, S) -> (last-token logits (B, Vp) f32,
    cache) with K/V (n_blocks, B, T, KV, HD), T = ``capacity`` (>= S,
    default S), and ``pos`` S.  S must be a multiple of ``scan_chunk``
    and ``q_chunk`` or shorter than them.  ``par``: under that mesh
    (module docstring)."""
    dt = DTYPES[cfg.compute_dtype]
    cdt = DTYPES[cfg.cache_dtype]
    nb, mpb = _n_blocks(cfg), cfg.mamba_per_block
    x = _embed_prompt(params, tokens, par).to(dt)
    B, S, D = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    shared = _cast(_whole(params["shared_attn"], par), dt)
    zero = init_mamba2_state(B, D, cfg.ssm_head_dim, cfg.ssm_state,
                             device=x.device, par=par)
    states, ks, vs = [], [], []
    for bi in range(nb):
        blk = _cast(_whole(_layer(params["blocks"], bi), par), dt)
        for mi in range(mpb):
            lp = _layer(blk, mi)
            h, st = mamba2_block(lp["mamba"], rmsnorm(x, lp["ln"]), zero,
                                 cfg.ssm_head_dim, cfg.scan_chunk, par)
            x = x + h
            states.append(st)
        h, (k, v) = attention(shared, rmsnorm(x, params["shared_ln"]), cfg,
                              positions, cfg.q_chunk, return_kv=True)
        x = x + h
        ks.append(k.to(cdt))
        vs.append(v.to(cdt))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if capacity is not None and capacity > S:
        pad = (0, 0, 0, 0, 0, capacity - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    mamba = {k: torch.stack([st[k] for st in states]).reshape(
                 nb, mpb, *zero[k].shape) for k in zero}
    pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _head(params, cfg, x[:, -1:], par), {"mamba": mamba, "k": ks,
                                                "v": vs, "pos": pos}


@torch.no_grad()
def decode(params, cfg: ArchConfig, token: torch.Tensor, cache,
           done: torch.Tensor | None = None, par=None):
    """One-token decode, token (B,) -> (logits (B, Vp) f32, cache).  The
    Mamba2 states, the K/V caches and ``pos`` are updated in place, so
    the step can be captured in a CUDA graph.  ``done`` is ignored, as
    the reference's decode ignores it: every row writes at ``pos``, which
    advances for all, and a finished row's tokens are ``PAD_ID``
    whatever it holds.  ``par``: under that mesh."""
    dt = DTYPES[cfg.compute_dtype]
    nb, mpb = _n_blocks(cfg), cfg.mamba_per_block
    x = _full(params["embed"], par)[token][:, None].to(dt)
    pos = cache["pos"].expand(x.shape[0])        # one position, every row
    shared = _cast(_whole(params["shared_attn"], par), dt)
    states = cache["mamba"]
    for bi in range(nb):
        blk = _cast(_whole(_layer(params["blocks"], bi), par), dt)
        for mi in range(mpb):
            lp = _layer(blk, mi)
            st = {k: v[bi, mi] for k, v in states.items()}
            h, new = mamba2_block(lp["mamba"], rmsnorm(x, lp["ln"]), st,
                                  cfg.ssm_head_dim, chunk=1, par=par)
            x = x + h
            for k, v in new.items():
                st[k].copy_(v)
        x = x + decode_attention(shared, rmsnorm(x, params["shared_ln"]),
                                 cache["k"][bi], cache["v"][bi], pos, cfg)
    cache["pos"].add_(1)
    return _head(params, cfg, x, par), cache
