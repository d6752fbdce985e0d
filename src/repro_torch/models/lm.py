"""Decoder-only transformer LM, dense family (port of the serving half of
``repro/models/lm.py``).

Parameters are a nested dict of tensors in the reference's layout: every
per-layer leaf is stacked on axis 0 (``params["layers"]["mlp"]["w_up"]`` is
(L, D, F)), so ``convert.params_from_jax`` is a plain tree copy.  Prepared
DS-CIM weights (``QuantizedLinearWeight``) slice per layer the same way.
The layer loop is a Python loop; prefill builds the dense KV cache, and
decode reads either the dense cache or the int8 paged one.  ``decode_multi``
scores a window of T tokens per row in one forward (the verifier of
self-speculative decoding).

Salts: layer ``li`` owns the salt space ``8*li`` (MLP sites 0..2,
attention 4..7) and the head takes ``8*n_layers``, as in the reference,
so the DS-CIM noise modes draw distinct noise at every call site.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig
from ..core.qweights import QuantizedLinearWeight, map_params
from ..device import resolve_device
from ..layers.attention import (attention, decode_attention,
                                decode_attention_multi,
                                decode_attention_paged,
                                decode_attention_paged_multi, flush_plan,
                                per_position, window_positions)
from ..layers.mlp import mlp
from ..layers.norms import rmsnorm

__all__ = ["init_params", "prefill", "decode", "decode_multi",
           "cast_layers", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _parse_dscim(dscim_spec: str):
    """'<mode>[+attn]:<variant>:<L>[:calib]' -> (mode, attn, variant, L,
    calib)."""
    from ..core.qweights import split_dscim_mode
    parts = dscim_spec.split(":")
    if len(parts) < 3:
        raise ValueError(f"bad dscim spec {dscim_spec!r}; want "
                         "'<mode>[+attn]:<variant>:<L>[:calib]', e.g. "
                         "'kernel:dscim1:256'")
    mode, attn = split_dscim_mode(dscim_spec)
    calib = parts[3] if len(parts) > 3 else "paper"
    return mode, attn, parts[1], int(parts[2]), calib


@functools.lru_cache(maxsize=16)
def _linear_for(dscim_spec: str):
    """DS-CIM linear for cfg.dscim (MLP matmuls and LM head), None if off."""
    if dscim_spec == "off":
        return None
    from ..core.dscim_layer import make_linear
    mode, _, variant, length, calib = _parse_dscim(dscim_spec)
    return make_linear(variant, length, mode, calib)


def _attn_linear_for(dscim_spec: str):
    """The attention-projection operator: non-None only for '+attn'."""
    if dscim_spec == "off" or not _parse_dscim(dscim_spec)[1]:
        return None
    return _linear_for(dscim_spec)


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random f32 parameters in the reference's layout and scales, drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    if cfg.family != "dense" or cfg.norm != "rmsnorm" or cfg.stub_frontend:
        raise NotImplementedError(f"{cfg.name}: only the dense rmsnorm "
                                  "family is ported")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv, cfg.head_dim

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    attn = {"wq": randn(L, D, H * HD, std=D ** -0.5),
            "wk": randn(L, D, KV * HD, std=D ** -0.5),
            "wv": randn(L, D, KV * HD, std=D ** -0.5),
            "wo": randn(L, H * HD, D, std=(H * HD) ** -0.5)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(L, HD)}
        attn["k_norm"] = {"scale": ones(L, HD)}
    params = {
        "layers": {
            "ln1": {"scale": ones(L, D)},
            "ln2": {"scale": ones(L, D)},
            "attn": attn,
            "mlp": {"w_up": randn(L, D, F, std=D ** -0.5),
                    "w_down": randn(L, F, D, std=F ** -0.5),
                    "w_gate": randn(L, D, F, std=D ** -0.5)},
        },
        "final_norm": {"scale": ones(D)},
        "embed": randn(cfg.vocab_padded, D, std=0.02),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = randn(D, cfg.vocab_padded, std=D ** -0.5)
    return params


def _cast(tree, dtype):
    """Cast the f32 leaves to the compute dtype; prepared weights pass
    through (their int8 planes are the compute representation and their
    scales stay f32)."""
    return map_params(
        lambda _, a: a.to(dtype) if isinstance(a, torch.Tensor)
        and a.dtype == torch.float32 else a, tree)


def cast_layers(params, dtype: torch.dtype):
    """``_cast`` of all layers at once: serving casts up front, so the
    per-layer casts in the layer loops find nothing left to convert."""
    return dict(params, layers=_cast(params["layers"], dtype))


def _layer(layers, i: int):
    """Layer ``i`` of the stacked per-layer tree."""
    return map_params(lambda _, a: a[i], layers)


def _head(params, cfg: ArchConfig, x):
    lin = _linear_for(cfg.dscim)
    salt = 8 * cfg.n_layers
    head = params.get("lm_head")
    if isinstance(head, QuantizedLinearWeight):
        return lin(x.to(torch.float32), head, salt=salt).to(torch.float32)
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = head.to(x.dtype)
    if lin is not None:
        return lin(x.to(torch.float32), w.to(torch.float32),
                   salt=salt).to(torch.float32)
    return (x @ w).to(torch.float32)


def _ff(cfg: ArchConfig, lp, x, salt):
    return mlp(lp["mlp"], rmsnorm(x, lp["ln2"]), cfg.mlp_kind,
               linear=_linear_for(cfg.dscim), salt=salt)



@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            capacity: int | None = None):
    """Forward over the prompt + KV-cache construction.  tokens (B, S) ->
    (last-token logits (B, Vp) f32, {"k","v": (L, B, T, KV, HD), "pos":
    (B,) int32}) with T = ``capacity`` (>= S, default S)."""
    dt = DTYPES[cfg.compute_dtype]
    cdt = DTYPES[cfg.cache_dtype]
    x = params["embed"][tokens].to(dt)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = _cast(_layer(params["layers"], li), dt)
        h, (k, v) = attention(lp["attn"], rmsnorm(x, lp["ln1"]), cfg,
                              positions, cfg.q_chunk, return_kv=True,
                              linear=_attn_linear_for(cfg.dscim),
                              salt=8 * li)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li)
        ks.append(k.to(cdt))
        vs.append(v.to(cdt))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if capacity is not None and capacity > S:
        pad = (0, 0, 0, 0, 0, capacity - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    x = rmsnorm(x[:, -1:], params["final_norm"])
    logits = _head(params, cfg, x)[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"k": ks, "v": vs, "pos": pos}


def _advance(pos, done):
    """Per-slot position advance, in place (a captured decode step keeps
    its addresses): finished rows stop moving."""
    if done is None:
        pos.add_(1)
    else:
        pos.add_((~done).to(pos.dtype))
    return pos


@torch.no_grad()
def decode(params, cfg: ArchConfig, token: torch.Tensor, cache,
           done: torch.Tensor | None = None):
    """One-token decode.  token (B,) -> (logits (B, Vp) f32, cache).  The
    cache's tensors, ``pos`` included, are updated in place: ``pos``
    advances (finished ``done`` slots stay put), so every address stays
    what it was and the step can be captured in a CUDA graph.  A cache carrying ``k_pages`` is the int8
    paged layout (core/kvcache.py)."""
    if "k_pages" in cache:
        return _decode_paged(params, cfg, token, cache, done)
    dt = DTYPES[cfg.compute_dtype]
    x = params["embed"][token][:, None].to(dt)
    pos = cache["pos"]
    for li in range(cfg.n_layers):
        lp = _cast(_layer(params["layers"], li), dt)
        h = decode_attention(lp["attn"], rmsnorm(x, lp["ln1"]),
                             cache["k"][li], cache["v"][li], pos, cfg,
                             linear=_attn_linear_for(cfg.dscim), salt=8 * li)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li)
    x = rmsnorm(x, params["final_norm"])
    logits = _head(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=_advance(pos, done))


def _decode_paged(params, cfg: ArchConfig, token, cache, done=None):
    dt = DTYPES[cfg.compute_dtype]
    x = params["embed"][token][:, None].to(dt)
    plan = flush_plan(cache["page_table"], cache["pos"],
                      cache["k_pages"].shape[2], done)
    for li in range(cfg.n_layers):
        lp = _cast(_layer(params["layers"], li), dt)
        view = {name: cache[name][li] for name in
                ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
                 "v_tail")}
        view.update(page_table=cache["page_table"], pos=cache["pos"],
                    flush=plan)
        h = decode_attention_paged(lp["attn"], rmsnorm(x, lp["ln1"]), view,
                                   cfg, linear=_attn_linear_for(cfg.dscim),
                                   salt=8 * li, done=done)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li)
    x = rmsnorm(x, params["final_norm"])
    logits = _head(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=_advance(cache["pos"], done))


def _window(fn, lin, x):
    """``fn`` over a (B, T, ...) window: batched where the DS-CIM operator
    ``lin`` it ends in has batch-invariant rows, else per position at the
    decode's shape."""
    if getattr(lin, "batch_invariant", False):
        return fn(x)
    return per_position(fn, x)


@torch.no_grad()
def decode_multi(params, cfg: ArchConfig, tokens: torch.Tensor, cache,
                 done: torch.Tensor | None = None):
    """Speculative-verify decode: score T consecutive tokens per row in one
    forward.  tokens (B, T); ``cache["pos"]`` (B,).  Position t of the
    logits is bitwise what ``decode`` gives for token t after decoding
    tokens 0..t-1 (same weights, same salts, same ops at the same
    shapes): the DS-CIM
    matmuls whose rows are batch invariant (``DSCIMLinear.batch_invariant``:
    exact, lut, bitmatmul, kernel) run once over the B*T rows; every other
    op that mixes elements of a row (the norms, float matmuls, attention,
    the noise modes' per-element draws) runs per position at the decode's
    shape (B, 1, ...), and elementwise ops batch.  The cache is updated in
    place; ``pos`` advances by T (done rows stay put).

    Returns (logits (B, T, Vp) f32, cache, win_kv) where win_kv is
    (win_k, win_v) (n_layers, B, T, KV, HD) in the tail dtype for the
    paged layout (``core/kvcache.py spec_rollback`` consumes them) and
    None for the dense layout."""
    dt = DTYPES[cfg.compute_dtype]
    B, T = tokens.shape
    x = params["embed"][tokens].to(dt)                       # (B, T, D)
    pos = cache["pos"]
    lin = _linear_for(cfg.dscim)
    alin = _attn_linear_for(cfg.dscim)
    paged = "k_pages" in cache
    if paged:
        ps = cache["k_pages"].shape[2]
        window = [(pt, flush_plan(cache["page_table"], pt, ps, done))
                  for pt in window_positions(pos, T, done)]
    wks, wvs = [], []
    for li in range(cfg.n_layers):
        lp = _cast(_layer(params["layers"], li), dt)
        hn = per_position(lambda v: rmsnorm(v, lp["ln1"]), x)
        if paged:
            view = {name: cache[name][li] for name in
                    ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
                     "v_tail")}
            view.update(page_table=cache["page_table"], pos=pos,
                        window=window)
            h, (wk, wv) = decode_attention_paged_multi(
                lp["attn"], hn, view, cfg, linear=alin, salt=8 * li,
                done=done)
            wks.append(wk)
            wvs.append(wv)
        else:
            h = decode_attention_multi(lp["attn"], hn, cache["k"][li],
                                       cache["v"][li], pos, cfg, linear=alin,
                                       salt=8 * li, done=done)
        x = x + h
        hn = per_position(lambda v: rmsnorm(v, lp["ln2"]), x)
        x = x + _window(lambda v: mlp(lp["mlp"], v, cfg.mlp_kind, linear=lin,
                                      salt=8 * li), lin, hn)
    x = per_position(lambda v: rmsnorm(v, params["final_norm"]), x)
    logits = _window(lambda v: _head(params, cfg, v), lin, x)
    step = T if done is None else (~done).to(pos.dtype) * T
    pos.add_(step)
    win_kv = (torch.stack(wks), torch.stack(wvs)) if paged else None
    return logits, cache, win_kv
