"""Decoder-only transformer LM, dense and MoE families (port of
``repro/models/lm.py``): olmo-1b, qwen3-0.6b,
starcoder2-7b, codeqwen1.5-7b, the MoE models deepseek-moe-16b and
granite-moe-1b-a400m (``layers/moe.py`` in place of the MLP; expert
parallelism over ``model`` under a mesh), and the stub-frontend backbones musicgen-large and
pixtral-12b, whose inputs are embeddings (``embeds=`` (B, S, D) to
``prefill``, ``embed=`` (B, 1, D) to ``decode``) and whose head is always
``lm_head``.

Parameters are a nested dict of tensors in the reference's layout: every
per-layer leaf is stacked on axis 0 (``params["layers"]["mlp"]["w_up"]`` is
(L, D, F)), so ``convert.params_from_jax`` is a plain tree copy.  Prepared
DS-CIM weights (``QuantizedLinearWeight``) slice per layer the same way.
The layer loop is a Python loop; ``forward`` is the training and scoring
pass (out of place, each layer rematerialized under ``cfg.remat``, with
``lm_loss``); prefill builds the dense KV cache, and decode reads either
the dense cache or the int8 paged one.  ``decode_multi`` scores a
window of T tokens per row in one forward (the verifier of
self-speculative decoding).

Serving under a mesh (``par``, a ``parallel.ParallelCtx``, to
``prefill``, ``decode`` and ``decode_multi``): SPMD over
``torch.distributed``, params placed by ``launch/sharding.py``; see
``prefill``.  Training under a mesh runs ``forward`` on whole gathered
leaves, the MoE experts with expert parallelism on this rank's experts
(launch/steps.py ``make_train_step(par=)``).

Salts: layer ``li`` owns the salt space ``8*li`` (MLP or shared-expert
sites 0..2, attention 4..7) and the head takes ``8*n_layers``, as in the
reference, so the DS-CIM noise modes draw distinct noise at every call
site.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig
from ..core.qweights import map_params
from ..device import resolve_device
from ..layers import moe as moe_layer
from ..layers.attention import (attention, decode_attention,
                                decode_attention_multi,
                                decode_attention_paged,
                                decode_attention_paged_multi, flush_plan,
                                per_position, window_positions)
from ..layers.mlp import mlp
from ..layers.norms import layernorm, rmsnorm
from ..layers.remat import remat
from ..parallel import Sharded, is_prepared

__all__ = ["init_params", "forward", "lm_loss", "embed", "prefill",
           "decode", "decode_multi", "cast_layers", "DTYPES"]

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


def _parse_fault(fault: str):
    """'stuck:<stride>:<value>' -> (stride, value): every <stride>-th
    output column of a DS-CIM linear reads back the constant <value>, the
    trace-level model of stuck-at OR-accumulation columns in the CIM
    array (runtime/failover.py arms it through cfg.dscim_fault)."""
    parts = fault.split(":")
    if len(parts) != 3 or parts[0] != "stuck":
        raise ValueError(f"bad dscim_fault {fault!r}; want "
                         "'stuck:<stride>:<value>'")
    stride = int(parts[1])
    if stride < 1:
        raise ValueError(f"dscim_fault stride must be >= 1, got {stride}")
    return stride, float(parts[2])


class _Faulted:
    """A DS-CIM operator whose every ``stride``-th output column reads
    ``value``.  The weights are never touched, so an exact-mode probe on
    the same prepared planes stays a clean reference; every other
    attribute (``group_k``, ``mode``, ``batch_invariant``, ...) is the
    wrapped operator's."""

    def __init__(self, op, stride: int, value: float):
        self.op, self.stride, self.value = op, stride, value

    def __getattr__(self, name):
        return getattr(self.op, name)

    def __call__(self, x, w, *, salt=None):
        y = self.op(x, w, salt=salt)
        stuck = torch.arange(y.shape[-1], device=y.device) % self.stride == 0
        return torch.where(stuck, self.value, y)


@functools.lru_cache(maxsize=16)
def _linear_for(dscim_spec: str, fault: str = "", par=None):
    """DS-CIM linear for cfg.dscim (MLP matmuls and LM head), None if off.
    ``fault`` (cfg.dscim_fault): 'stuck:<stride>:<value>' wraps it in
    ``_Faulted``.  ``par``: the operator is placed on that mesh
    (``DSCIMLinear.par``: 'kernel' runs the N-sharded fused MVM)."""
    if dscim_spec == "off":
        return None
    from ..core.dscim_layer import make_linear
    mode, _, variant, length, calib = _parse_dscim(dscim_spec)
    op = make_linear(variant, length, mode, calib, par=par)
    if not fault:
        return op
    return _Faulted(op, *_parse_fault(fault))


def _attn_linear_for(dscim_spec: str, fault: str = "", par=None):
    """The attention-projection operator: non-None only for '+attn'."""
    if dscim_spec == "off" or not _parse_dscim(dscim_spec)[1]:
        return None
    return _linear_for(dscim_spec, fault, par)


def _lin(cfg: ArchConfig, par=None):
    """cfg's DS-CIM operator for the MLP matmuls and the head."""
    return _linear_for(cfg.dscim, cfg.dscim_fault, par)


def _alin(cfg: ArchConfig, par=None):
    """cfg's attention-projection operator (None unless '+attn')."""
    return _attn_linear_for(cfg.dscim, cfg.dscim_fault, par)


def _full(leaf, par):
    """A float leaf whole on this rank: a ``Sharded`` piece gathered over
    the mesh (the reference's explicit ZeRO-3 gather before use)."""
    return leaf if par is None else par.whole(leaf)


def _whole(tree, par):
    """``_full`` of every float leaf of one layer's tree but the MoE's
    routed experts, which ``_moe_apply`` gathers over the FSDP axis only
    (their expert dim stays split over ``model``); prepared N-slices stay
    for the sharded fused MVM."""
    if par is None:
        return tree
    return map_params(lambda path, a: a if "moe/experts" in path
                      else par.whole(a), tree)


def _norm(cfg: ArchConfig, x, params):
    """cfg's norm: RMSNorm, or LayerNorm (``layernorm``: scale only;
    ``layernorm_np``: none)."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params)
    return layernorm(x, params)


def generator(dev: torch.device, seed: int):
    """The ``torch.Generator`` an ``init_params`` draws from, or None on
    the ``meta`` device, where the draws have shapes only (a tree's
    structure, e.g. a checkpoint's restore target)."""
    if dev.type == "meta":
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random f32 parameters in the reference's layout and scales, drawn
    from a ``torch.Generator`` seeded with ``seed``: norms with a scale
    (none for ``layernorm_np``), no ``w_gate`` for the GELU MLP, q heads
    padded to ``head_pad_to`` with zero ``wq`` columns and zero ``wo``
    rows, no ``embed`` for a stub frontend and an ``lm_head`` unless the
    head is tied to ``embed``.  An MoE config has ``moe`` in place of
    ``mlp``: ``router`` (L, D, E), ``experts`` {w_gate, w_up (L, E, D,
    F), w_down (L, E, F, D)} and, with shared experts, ``shared`` (a
    SwiGLU MLP of width ``moe_shared * d_ff``), scaled as the reference's
    ``init_moe``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: {cfg.family!r} models are "
                                  "not served by this module")
    dev = resolve_device(device)
    gen = generator(dev, seed)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv, cfg.head_dim
    hp = cfg.q_heads

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def norm(*lead):
        return {} if cfg.norm == "layernorm_np" else {"scale": ones(*lead, D)}

    def ffn(width, kind):
        p = {"w_up": randn(L, D, width, std=D ** -0.5),
             "w_down": randn(L, width, D, std=width ** -0.5)}
        if kind == "swiglu":
            p["w_gate"] = randn(L, D, width, std=D ** -0.5)
        return p

    attn = {"wq": randn(L, D, hp * HD, std=D ** -0.5),
            "wk": randn(L, D, KV * HD, std=D ** -0.5),
            "wv": randn(L, D, KV * HD, std=D ** -0.5),
            "wo": randn(L, hp * HD, D, std=(H * HD) ** -0.5)}
    attn["wq"][..., H * HD:] = 0.0        # pad heads: the function is
    attn["wo"][:, H * HD:] = 0.0          # exactly the unpadded one's
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(L, HD)}
        attn["k_norm"] = {"scale": ones(L, HD)}
    layers = {"ln1": norm(L), "ln2": norm(L), "attn": attn}
    if cfg.family == "moe":
        E = cfg.moe_experts
        layers["moe"] = {
            "router": randn(L, D, E, std=D ** -0.5),
            "experts": {"w_gate": randn(L, E, D, F, std=D ** -0.5),
                        "w_up": randn(L, E, D, F, std=D ** -0.5),
                        "w_down": randn(L, E, F, D, std=F ** -0.5)}}
        if cfg.moe_shared:
            layers["moe"]["shared"] = ffn(cfg.moe_shared * F, "swiglu")
    else:
        layers["mlp"] = ffn(F, cfg.mlp_kind)
    params = {"layers": layers, "final_norm": norm()}
    if not cfg.stub_frontend:
        params["embed"] = randn(cfg.vocab_padded, D, std=0.02)
    if not cfg.tie_embeddings or cfg.stub_frontend:
        params["lm_head"] = randn(D, cfg.vocab_padded, std=D ** -0.5)
    return params


def _cast(tree, dtype):
    """Cast the f32 leaves to the compute dtype; prepared weights pass
    through (their int8 planes are the compute representation and their
    scales stay f32)."""
    return map_params(
        lambda _, a: a.to(dtype) if isinstance(a, (torch.Tensor, Sharded))
        and a.dtype == torch.float32 else a, tree)


def cast_layers(params, dtype: torch.dtype):
    """``_cast`` of all layers at once: serving casts up front, so the
    per-layer casts in the layer loops find nothing left to convert."""
    return dict(params, layers=_cast(params["layers"], dtype))


def _layer(layers, i: int):
    """Layer ``i`` of the stacked per-layer tree."""
    return map_params(lambda _, a: a[i], layers)


def unstack(tree, n: int) -> list:
    """The n per-layer trees of a stacked tree (leaves stacked on axis 0).
    A tensor is split by ``unbind``, whose backward stacks the n layers'
    gradients once (a per-layer ``a[i]`` would add a full-size gradient
    for every layer); other leaves (prepared weights) are indexed."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, Sharded) and isinstance(tree.local, torch.Tensor):
        return [Sharded(t, tree.spec[1:], tree.shape[1:])
                for t in unstack(tree.local, n)]
    return [tree[i] for i in range(n)]


def _head(params, cfg: ArchConfig, x, par=None):
    lin = _lin(cfg, par)
    salt = 8 * cfg.n_layers
    head = params.get("lm_head")
    if is_prepared(head):
        return lin(x.to(torch.float32), head, salt=salt).to(torch.float32)
    if cfg.tie_embeddings and not cfg.stub_frontend:
        w = _full(params["embed"], par).to(x.dtype).T
    else:
        w = _full(head, par).to(x.dtype)
    if lin is not None:
        return lin(x.to(torch.float32), w.to(torch.float32),
                   salt=salt).to(torch.float32)
    return (x @ w).to(torch.float32)


def _moe_apply(p, hn, cfg: ArchConfig, par, salt):
    """The MoE block on the normed ``hn`` (the reference's ``_moe_apply``):
    on one device ``layers/moe.py moe``; under a mesh the routed experts
    with expert parallelism (``moe_routed(par=)``: the batch over DP, the
    experts over ``model``, two ``all_to_all``s) and the shared expert
    computed on every rank with the operator of one device (a prepared
    shared expert is whole on every rank; a float one was gathered by
    ``_whole``), added in the single-device order."""
    if par is None:
        return moe_layer.moe(p, hn, top_k=cfg.moe_topk,
                             capacity_factor=cfg.moe_capacity,
                             has_shared=cfg.moe_shared > 0,
                             linear=_lin(cfg), salt=salt)
    out, _ = moe_layer.moe_routed(p, hn, top_k=cfg.moe_topk,
                                  capacity_factor=cfg.moe_capacity, par=par)
    if cfg.moe_shared:
        out = out + mlp(p["shared"], hn, "swiglu", linear=_lin(cfg),
                        salt=salt)
    return out


def _ff(cfg: ArchConfig, lp, x, salt, par=None):
    """The block's feed-forward half on the residual ``x``: the MLP, or
    for an MoE config the MoE block (``_moe_apply``), after the second
    norm."""
    hn = _norm(cfg, x, lp["ln2"])
    if cfg.family == "moe":
        return _moe_apply(lp["moe"], hn, cfg, par, salt)
    return mlp(lp["mlp"], hn, cfg.mlp_kind, linear=_lin(cfg, par),
               salt=salt)


def _ff_window(cfg: ArchConfig, lp, hn, lin, salt, par=None):
    """``_ff``'s feed-forward on a normed (B, T, D) window, position t
    bitwise what ``_ff`` gives at (B, 1, D): the MLP through ``_window``;
    the MoE's routed experts per position (routing, and the capacity,
    depend on the rows of a call), its shared expert through
    ``_window`` with the operator ``_moe_apply`` gives it."""
    if cfg.family != "moe":
        return _window(lambda v: mlp(lp["mlp"], v, cfg.mlp_kind,
                                     linear=lin, salt=salt), lin, hn)
    p = lp["moe"]
    out = per_position(lambda v: moe_layer.moe_routed(
        p, v, top_k=cfg.moe_topk,
        capacity_factor=cfg.moe_capacity, par=par)[0], hn)
    if cfg.moe_shared:
        slin = _lin(cfg)
        out = out + _window(lambda v: mlp(p["shared"], v, "swiglu",
                                          linear=slin, salt=salt), slin, hn)
    return out


def _embed_prompt(params, tokens: torch.Tensor, par=None) -> torch.Tensor:
    """Embedding rows of caller-given ids (a prompt, an extend chunk), as
    the reference's gather reads them: a negative id wraps once (adds
    the table's size), then an id still outside the table is clamped
    into it, where indexing would raise on the CPU and trap on the card.
    Sampled ids are in range and index the table directly."""
    emb = _full(params["embed"], par)
    V = emb.shape[0]
    return emb[torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1)]


def _inputs(cfg: ArchConfig, tokens, embeds, dt, embed_rows):
    """The model's input rows in ``dt``: ``embeds`` for a stub-frontend
    config (which requires them), else ``embed_rows(tokens)`` (a token
    config refuses embeddings)."""
    if cfg.stub_frontend:
        if embeds is None or tokens is not None:
            raise ValueError(f"{cfg.name} has a stub frontend: pass its "
                             "input embeddings as embeds=/embed=, no "
                             "token ids")
        return embeds.to(dt)
    if embeds is not None:
        raise ValueError(f"{cfg.name} takes token ids, not embeddings")
    return embed_rows(tokens).to(dt)


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of in-range ``tokens`` for a forward that is
    differentiated: ``F.embedding``, whose backward sums a row's repeats
    in one fixed order on the CPU and on CUDA (an index's backward adds
    them with atomics on the CPU, in an order that varies)."""
    return torch.nn.functional.embedding(tokens, params["embed"])


def _train_layer(cfg: ArchConfig, li: int, par, positions, x, lp):
    """Layer ``li`` of ``forward`` (the reference's ``_block_apply``
    without a cache): (x, the layer's MoE aux, None for a dense config).
    The layer's weights are cast to the compute dtype here, inside the
    rematerialized body, as the reference casts them.  ``par``: the MoE
    block with expert parallelism."""
    lp = _cast(lp, x.dtype)
    h, _ = attention(lp["attn"], _norm(cfg, x, lp["ln1"]), cfg, positions,
                     cfg.q_chunk, linear=_alin(cfg), salt=8 * li)
    x = x + h
    hn = _norm(cfg, x, lp["ln2"])
    if cfg.family == "moe":
        h, aux = moe_layer.moe_with_aux(
            lp["moe"], hn, top_k=cfg.moe_topk,
            capacity_factor=cfg.moe_capacity, has_shared=cfg.moe_shared > 0,
            linear=_lin(cfg), salt=8 * li, par=par)
        return x + h, aux
    return x + mlp(lp["mlp"], hn, cfg.mlp_kind, linear=_lin(cfg),
                   salt=8 * li), None


def forward(params, cfg: ArchConfig, tokens: torch.Tensor | None, *,
            embeds: torch.Tensor | None = None, par=None):
    """Training and scoring forward over whole sequences: tokens (B, S),
    or for a stub-frontend config ``tokens=None`` and ``embeds`` (B, S,
    D) -> (logits (B, S, Vp) f32, aux 0-d f32), aux the MoE load-balance
    loss averaged over the layers (0 for a dense config).  Each layer is
    rematerialized in the backward pass when ``cfg.remat`` (the
    reference's per-layer ``jax.checkpoint``).  Nothing is written in
    place, so autograd can differentiate it; the serving paths (prefill,
    decode) are separate.  ``par``: the train step's view of its mesh
    (``ParallelCtx.train_view``): the leaves are whole but the MoE
    experts' (this rank's, ``Sharded`` over ``model``), which run with
    expert parallelism."""
    dt = DTYPES[cfg.compute_dtype]
    x = _inputs(cfg, tokens, embeds, dt, lambda t: embed(params, t))
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x, a = remat(functools.partial(_train_layer, cfg, li, par),
                     positions, x, lp, on=cfg.remat)
        if a is not None:
            aux = aux + a
    x = _norm(cfg, x, params["final_norm"])
    return _head(params, cfg, x), aux / cfg.n_layers


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy over the padded vocabulary; logits (B, S,
    Vp) f32, labels (B, S).  The label's logit is a gather, whose
    backward writes one element a row (no two adds meet)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor | None,
            capacity: int | None = None, *,
            embeds: torch.Tensor | None = None, par=None):
    """Forward over the prompt + KV-cache construction.  tokens (B, S), or
    for a stub-frontend config ``tokens=None`` and ``embeds`` (B, S, D) ->
    (last-token logits (B, Vp) f32, {"k","v": (L, B, T, KV, HD), "pos":
    (B,) int32}) with T = ``capacity`` (>= S, default S).

    ``par`` (a ``ParallelCtx``; likewise for ``decode`` and
    ``decode_multi``): ``params`` are placed on that mesh
    (launch/sharding.py).  Each layer's float leaves are gathered whole
    before use, so the float math is the single-device math; the DS-CIM
    matmuls run the N-sharded fused MVM, the paged read cuts the batch
    over DP and the MoE's experts run with expert parallelism.  Inputs,
    cache and outputs are whole on every rank."""
    dt = DTYPES[cfg.compute_dtype]
    cdt = DTYPES[cfg.cache_dtype]
    x = _inputs(cfg, tokens, embeds, dt,
                lambda t: _embed_prompt(params, t, par))
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        h, (k, v) = attention(lp["attn"], _norm(cfg, x, lp["ln1"]), cfg,
                              positions, cfg.q_chunk, return_kv=True,
                              linear=_alin(cfg, par),
                              salt=8 * li)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li, par)
        ks.append(k.to(cdt))
        vs.append(v.to(cdt))
    ks, vs = torch.stack(ks), torch.stack(vs)
    if capacity is not None and capacity > S:
        pad = (0, 0, 0, 0, 0, capacity - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    x = _norm(cfg, x[:, -1:], params["final_norm"])
    logits = _head(params, cfg, x, par)[:, 0]
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
def decode(params, cfg: ArchConfig, token: torch.Tensor | None, cache,
           done: torch.Tensor | None = None, *,
           embed: torch.Tensor | None = None, par=None):
    """One-token decode.  token (B,), or for a stub-frontend config
    ``token=None`` and ``embed`` (B, 1, D) -> (logits (B, Vp) f32,
    cache).  The cache's tensors, ``pos`` included, are updated in place:
    ``pos`` advances (finished ``done`` slots stay put), so every address
    stays what it was and the step can be captured in a CUDA graph.  A
    cache carrying ``k_pages`` is the int8 paged layout
    (core/kvcache.py)."""
    dt = DTYPES[cfg.compute_dtype]
    x = _inputs(cfg, token, embed, dt,
                lambda t: _full(params["embed"], par)[t][:, None])
    if "k_pages" in cache:
        return _decode_paged(params, cfg, x, cache, done, par)
    pos = cache["pos"]
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        h = decode_attention(lp["attn"], _norm(cfg, x, lp["ln1"]),
                             cache["k"][li], cache["v"][li], pos, cfg,
                             linear=_alin(cfg, par), salt=8 * li)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li, par)
    x = _norm(cfg, x, params["final_norm"])
    logits = _head(params, cfg, x, par)[:, 0]
    return logits, dict(cache, pos=_advance(pos, done))


def _decode_paged(params, cfg: ArchConfig, x, cache, done=None, par=None):
    """``decode``'s layer loop over the int8 paged cache; x (B, 1, D) in
    the compute dtype."""
    dt = x.dtype
    plan = flush_plan(cache["page_table"], cache["pos"],
                      cache["k_pages"].shape[2], done)
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        view = {name: cache[name][li] for name in
                ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
                 "v_tail")}
        view.update(page_table=cache["page_table"], pos=cache["pos"],
                    flush=plan)
        h = decode_attention_paged(lp["attn"], _norm(cfg, x, lp["ln1"]),
                                   view, cfg, linear=_alin(cfg, par),
                                   salt=8 * li, done=done, par=par)
        x = x + h
        x = x + _ff(cfg, lp, x, 8 * li, par)
    x = _norm(cfg, x, params["final_norm"])
    logits = _head(params, cfg, x, par)[:, 0]
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
                 done: torch.Tensor | None = None, par=None):
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
    if cfg.stub_frontend:
        raise ValueError("decode_multi (speculative verify) needs token "
                         "inputs; stub-frontend configs are unsupported")
    dt = DTYPES[cfg.compute_dtype]
    B, T = tokens.shape
    x = _embed_prompt(params, tokens, par).to(dt)            # (B, T, D)
    pos = cache["pos"]
    lin = _lin(cfg, par)
    alin = _alin(cfg, par)
    paged = "k_pages" in cache
    if paged:
        ps = cache["k_pages"].shape[2]
        window = [(pt, flush_plan(cache["page_table"], pt, ps, done))
                  for pt in window_positions(pos, T, done)]
    wks, wvs = [], []
    for li in range(cfg.n_layers):
        lp = _cast(_whole(_layer(params["layers"], li), par), dt)
        hn = per_position(lambda v: _norm(cfg, v, lp["ln1"]), x)
        if paged:
            view = {name: cache[name][li] for name in
                    ("k_pages", "v_pages", "k_scale", "v_scale", "k_tail",
                     "v_tail")}
            view.update(page_table=cache["page_table"], pos=pos,
                        window=window)
            h, (wk, wv) = decode_attention_paged_multi(
                lp["attn"], hn, view, cfg, linear=alin, salt=8 * li,
                done=done, par=par)
            wks.append(wk)
            wvs.append(wv)
        else:
            h = decode_attention_multi(lp["attn"], hn, cache["k"][li],
                                       cache["v"][li], pos, cfg, linear=alin,
                                       salt=8 * li, done=done)
        x = x + h
        hn = per_position(lambda v: _norm(cfg, v, lp["ln2"]), x)
        x = x + _ff_window(cfg, lp, hn, lin, 8 * li, par)
    x = per_position(lambda v: _norm(cfg, v, params["final_norm"]), x)
    logits = _window(lambda v: _head(params, cfg, v, par), lin, x)
    step = T if done is None else (~done).to(pos.dtype) * T
    pos.add_(step)
    win_kv = (torch.stack(wks), torch.stack(wvs)) if paged else None
    return logits, cache, win_kv
