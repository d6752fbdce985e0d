"""Step builders (port of ``repro/launch/steps.py``): the training and
scoring steps ``make_train_step`` / ``make_eval_step`` and the one-call
``make_prefill_step`` / ``make_decode_step``; and for serving
``prepare_serving_params``, the sampler, ``make_generate_fn`` and the
continuous-batching pieces ``init_serve_state`` / ``make_admit_fn`` /
``make_segment_fn`` / ``make_extend_fn``.

The train step differentiates ``forward`` (models/) with autograd and
updates in place through ``optim/adamw.py``; it runs eagerly, with
``dscim`` 'off' or 'float' only (``_check_train``).  Under a mesh
(``par``) it is the reference's FSDP/TP step as ZeRO-3: the placed
leaves are gathered whole outside autograd, each rank runs forward and
backward on its DP slice of the batch, the whole gradients are averaged
over the DP axes, and each rank updates its own pieces.

``prepare_serving_params`` converts every DS-CIM-eligible weight once into
resident int8 ``QuantizedLinearWeight`` planes.

The reference runs its generation loop inside one jitted ``lax.scan`` /
``while_loop``, with the cache in the loop carry.  Here one done-masked
decode step (``_make_step``: decode, draw, done/budget update, the token
written to column ``i`` of a static output, ``i`` a device counter) reads
and writes only static tensors in place, and ``launch/graph.py
CapturedStep`` captures it once as a CUDA graph and replays it.  The
same step serves:

* ``make_generate_fn`` (one-shot requests, every family through
  ``models/registry.py get_model``): prefill eagerly, copy the cache (or
  a recurrent family's state tree) into the runner's static buffers,
  then replay the step ``n_tokens - 1``
  times; the EOS loop looks at ``done`` on the host once every
  ``SEG_LEN`` replays only (done-masked steps are inert, so the tokens are those of a
  loop that stops at once).  ``scan=False`` is the eager host loop, one
  step and one ``done`` check per token: the A/B baseline.
* ``make_segment_fn`` (continuous batching): ``seg_len`` replays over the
  persistent serve state, between which ``make_admit_fn`` prefills new
  requests into freed slots, or ``make_extend_fn`` (the prefix cache's
  chunked prefill, one captured graph a chunk) feeds them page by page.

Under ``spec='<variant>:<k>'`` (self-speculative decoding, the port of
``_parse_spec``, ``_draft_cfg`` and ``_make_spec_window``) the captured
step is one draft/verify *window* instead (``_make_window``): k greedy
draft decodes through the cheaper estimator, one batched verify forward
(``models/lm.py decode_multi``), the accept fold over the k+1 positions
and the rollback, all in place on the same static state, so one window is
one graph replay.  Greedy emission is bitwise the plain loop's.

Sampled draws take their uniforms from ``core/counter_rng``, keyed by
(seed, the row's stream, the row's emitted count): a function of the data
computed on the device, so the graph replays it with no generator state,
a rejected draft consumes no draw, and the spec and plain paths draw the
same token at the same emission of a row.

On the CPU there are no graphs: the same step runs eagerly.

Under a mesh (``par``, a ``parallel.ParallelCtx``, to every serving
builder): ``prepare_serving_params`` places the prepared params by the
rules of ``launch/sharding.py`` and every step passes ``par`` to the
model, whose collectives the step then holds.  On NCCL the captured step
captures them too (one eager collective on each group before the first
capture sets the communicators up); a gloo group cannot be captured, so
with gloo on CUDA the step runs eagerly and the builders say so
(``generate.last_graph``, ``segment.eager_reason``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..configs.base import ArchConfig
from ..core import counter_rng, kvcache
from ..core.qweights import (QuantizedLinearWeight, golden_weight_copy,
                             map_params, prepare_dscim_params,
                             split_dscim_mode)
from ..device import resolve_device
from ..models import lm
from ..models.registry import get_model
from ..tree import leaves, unflatten
from .graph import CapturedStep

__all__ = ["make_train_step", "make_eval_step", "make_prefill_step",
           "make_decode_step", "prepare_serving_params", "make_generate_fn",
           "init_serve_state", "make_admit_fn", "make_segment_fn",
           "make_extend_fn", "make_probe_fn", "clear_graphs", "PAD_ID",
           "AUX_WEIGHT"]

PAD_ID = 0          # token written for finished slots
# the families with an attention KV cache: every serving loop takes them;
# the RWKV and hybrid families serve through serve_batch in float only
ATTENTION_FAMILIES = ("dense", "moe")
SEG_LEN = 4         # replays between two host looks at ``done``


AUX_WEIGHT = 0.01   # MoE load-balance loss weight


def _check_train(cfg: ArchConfig):
    """Training differentiates the float model: a DS-CIM spec other than
    'off' or 'float' is refused.  A 'kernel:' spec has no gradient (the
    reference fails there too: a ``pallas_call`` has none); training
    through the jnp DS-CIM modes waits for ROADMAP A15b."""
    if split_dscim_mode(cfg.dscim)[0] not in ("off", "float"):
        raise ValueError(f"training runs at dscim 'off' or 'float', not "
                         f"{cfg.dscim!r}: the 'kernel' modes have no "
                         "gradient, and training through the other DS-CIM "
                         "modes is ROADMAP A15b")


def _forward(model, params, cfg: ArchConfig, batch, dev, par=None):
    """``model.forward`` on the batch's inputs, moved to ``dev``:
    ``tokens`` (B, S), or ``embeds`` (B, S, D) for a stub frontend;
    ``par``: the train step's view of its mesh."""
    kw = {} if par is None else {"par": par}
    if cfg.stub_frontend:
        return model.forward(params, cfg, None,
                             embeds=torch.as_tensor(batch["embeds"],
                                                    device=dev), **kw)
    return model.forward(params, cfg,
                         torch.as_tensor(batch["tokens"], device=dev).long(),
                         **kw)


def _labels(batch, dev) -> torch.Tensor:
    return torch.as_tensor(batch["labels"], device=dev).long()


def make_train_step(cfg: ArchConfig, opt, device=None, par=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`` on ``device`` (CUDA unless the caller asks
    for another; the parameters and the state must live there): the
    token-mean cross-entropy plus ``AUX_WEIGHT`` times the MoE aux, its
    gradients by autograd, then ``opt.update`` (optim/adamw.py), which
    writes the parameters and the state in place.  ``batch`` holds
    ``tokens`` (or ``embeds``) and ``labels`` (B, S), numpy or tensors.
    The metrics stay on the device (reading one waits for the step).

    ``par`` (a ``ParallelCtx``): the params and the AdamW state are placed
    on that mesh (``Sharded`` pieces, launch/sharding.py) and every rank
    passes the same global batch.  Each step gathers every placed leaf
    whole outside autograd, runs forward and backward on whole leaves on
    this rank's slice of the batch over the DP axes (``batch_slice``;
    the whole batch where it does not divide), averages the loss and the
    whole gradients over the DP axes, takes the clip's global norm of
    that mean (the same on every rank) and updates this rank's pieces.
    The MoE experts run with expert parallelism, as the reference's mesh
    step runs them: each rank gathers its own experts over FSDP only and
    keeps their gradients, and the RWKV6 scan runs on this rank's heads.
    With no DP split (``model=N``) this is the one-device step bitwise,
    but for an MoE config with N > 1 (its aux is the mean of each
    sequence slice's, as the reference's)."""
    _check_train(cfg)
    model = get_model(cfg)
    dev = resolve_device(device)
    if par is not None:
        return _mesh_train_step(cfg, opt, model, dev, par)

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        logits, aux = _forward(model, params, cfg, batch, dev)
        loss = lm.lm_loss(logits, _labels(batch, dev)) + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        del logits
        params, opt_state, gnorm = opt.update(
            params, unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def _mesh_train_step(cfg: ArchConfig, opt, model, dev, par):
    """``make_train_step``'s step under the mesh ``par`` (ZeRO-3; the MoE
    experts with expert parallelism)."""
    import torch.distributed as dist

    from ..parallel import Sharded
    from .sharding import shard_for
    view = par.train_view
    fsdp = par.dp_axes[-1:]
    tp = par.tp_axis

    def dp_mean_(t):
        """``t`` (a fresh gradient) averaged over the DP axes in place: no
        second copy of the gradients at the step's peak."""
        for a in par.dp_axes:
            dist.all_reduce(t, group=par.group(a))
        return t.div_(par.dp_size)

    def local(batch):
        out = {}
        for k in ("tokens", "embeds", "labels"):
            if k in batch:
                out[k] = par.batch_slice(
                    torch.as_tensor(batch[k], device=dev))[0]
        return out

    def own(path, p):
        """A MoE expert leaf split over ``model``: this rank keeps its
        experts (gathered over FSDP only) and their gradients."""
        return isinstance(p, Sharded) and "moe/experts" in path \
            and p.spec[-3] == (tp,)

    def fsdp_dims(spec, keep):
        """``spec`` with only (``keep``) or all but (not ``keep``) its
        FSDP dims: an expert's piece cut over FSDP from its gathered
        gradient, or the spec of the gathered expert."""
        return tuple(a if bool(a and set(a) <= set(fsdp)) == keep else None
                     for a in spec)

    def train_step(params, opt_state, batch):
        placed = leaves(params)
        mine = leaves(map_params(own, params))
        with torch.no_grad():
            flat = [par.gather_spec(p.local, p.spec, only=fsdp)[0] if m
                    else par.whole(p) for p, m in zip(placed, mine)]
        flat = [w.detach().requires_grad_(True) for w in flat]
        model_leaves = [Sharded(w, fsdp_dims(p.spec, False), p.shape)
                        if m else w for w, p, m in zip(flat, placed, mine)]
        part = local(batch)
        logits, aux = _forward(model, unflatten(params, model_leaves), cfg,
                               part, dev, view)
        loss = lm.lm_loss(logits, _labels(part, dev)) + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        del logits, flat, model_leaves
        with torch.no_grad():
            grads = [dp_mean_(g) for g in grads]
            loss = dp_mean_(loss.detach().clone())
            # the clip's norm: every whole leaf once, and the experts'
            # squares summed over the ranks that hold them
            sq = [torch.sum(torch.square(g.to(torch.float32)))
                  for g in grads]
            if any(mine):
                ex = par.psum(torch.stack([q for q, m in zip(sq, mine)
                                           if m]), tp)
                it = iter(ex.unbind(0))
                sq = [next(it) if m else q for q, m in zip(sq, mine)]
            gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
            pieces = [g if not isinstance(p, Sharded) else shard_for(
                par.rank_coords, fsdp_dims(p.spec, True) if m else p.spec, g)
                for p, g, m in zip(placed, grads, mine)]
        params, opt_state, gnorm = opt.update(
            params, unflatten(params, pieces), opt_state, gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ArchConfig, device=None):
    """``eval_step(params, batch) -> loss`` on ``device`` (CUDA unless the
    caller asks for another): the token-mean cross-entropy of
    ``forward`` (no aux), without autograd."""
    model = get_model(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = _forward(model, params, cfg, batch, dev)
        return lm.lm_loss(logits, _labels(batch, dev))

    return eval_step


def _mesh_kw(par) -> dict:
    """The model's ``par`` keyword: {} on one device."""
    return {} if par is None else {"par": par}


def make_prefill_step(cfg: ArchConfig, capacity: int | None = None,
                      par=None):
    """``prefill_step(params, batch) -> (last logits, cache)``: the
    model's ``prefill`` of ``batch["tokens"]`` (or ``embeds``) with a
    cache of ``capacity`` positions; ``par``: under that mesh."""
    model = get_model(cfg)
    kw = _mesh_kw(par)

    def prefill_step(params, batch):
        if cfg.stub_frontend:
            return model.prefill(params, cfg, None, capacity,
                                 embeds=batch["embeds"], **kw)
        return model.prefill(params, cfg, batch["tokens"], capacity, **kw)

    return prefill_step


def make_decode_step(cfg: ArchConfig, return_logits: bool = False,
                     par=None):
    """``decode_step(params, batch, cache) -> (token, cache)``, or
    ``(token, logits, cache)`` with ``return_logits``: one greedy decode
    of ``batch["token"]`` (or ``embed``), the cache updated in place;
    ``par``: under that mesh."""
    model = get_model(cfg)
    kw = _mesh_kw(par)

    def decode_step(params, batch, cache):
        if cfg.stub_frontend:
            logits, cache = model.decode(params, cfg, None, cache,
                                         embed=batch["embed"], **kw)
        else:
            logits, cache = model.decode(params, cfg, batch["token"], cache,
                                         **kw)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        if return_logits:
            return token, logits, cache
        return token, cache

    return decode_step


def _whole_for_prepare(cfg: ArchConfig, params, par):
    """``params`` with the placed float leaves that preparation reads (the
    DS-CIM-eligible matrices, and the embedding a tied head is made from)
    gathered whole: a window's int8 scale spans its whole K and a column's
    whole N."""
    from ..core.qweights import dscim_patterns, ties_head
    pats = dscim_patterns(cfg)
    if ties_head(cfg, params):
        pats += ("embed",)
    return map_params(lambda path, a: par.whole(a) if any(
        t in path for t in pats) else a, params)


def prepare_serving_params(cfg: ArchConfig, params, par=None, *,
                           golden: bool = False):
    """Quantize-once weight preparation for DS-CIM serving; a no-op for
    'off'/'float' specs.  ``golden=True`` returns ``(prepared, blob)``
    with the host golden copy and digest vector of every prepared plane
    (core/qweights.py ``golden_weight_copy``, the integrity layer's
    repair source), taken here where the planes are good by
    construction; None for 'off'/'float'.  Under a mesh the copy is of
    this rank's pieces.

    ``par``: the prepared params placed on that mesh
    (launch/sharding.py ``shard_params``: prepared weights N over
    ``model``, the MoE's prepared shared expert whole, float leaves by
    their rules); params placed already (whole leaves or ``Sharded``
    pieces, e.g. ``convert.params_from_jax(par=)``) are prepared from
    their gathered matrices and placed again.  Placed prepared params
    pass through as they are."""
    spec = getattr(cfg, "dscim", "off")
    _check_dscim(cfg)
    if split_dscim_mode(spec)[0] in ("off", "float"):
        prepared = params
    else:
        lin = lm._linear_for(spec)
        src = params if par is None else _whole_for_prepare(cfg, params,
                                                            par)
        prepared = prepare_dscim_params(src, cfg,
                                        group_k=lin.group_k if lin else 128)
    if par is not None:
        from .sharding import shard_params
        prepared = shard_params(prepared, par)
    if split_dscim_mode(spec)[0] in ("off", "float"):
        return (prepared, None) if golden else prepared
    if golden:
        return prepared, golden_weight_copy(prepared)
    return prepared


def _check_kv(cfg: ArchConfig, kv: str):
    """What ``serve_batch`` takes: a token-input config and a 'float' or
    'int8' cache; the RWKV and hybrid families take the float cache and
    the 'off' and 'float' specs only (the reference pages no cache and
    prepares no DS-CIM weights for them)."""
    if kv not in ("float", "int8"):
        raise ValueError(f"kv must be 'float' or 'int8', got {kv!r}")
    if kv == "int8" and cfg.family not in ATTENTION_FAMILIES:
        raise ValueError("the paged int8 KV cache needs an attention-"
                         f"family model, not {cfg.family!r}")
    _check_dscim(cfg)
    if cfg.stub_frontend:
        raise ValueError(f"{cfg.name} takes embeddings (a stub frontend), "
                         "and the serving loops take token prompts: drive "
                         "models/lm.py prefill(embeds=) / decode(embed=)")


def _check_dscim(cfg: ArchConfig):
    if cfg.family not in ATTENTION_FAMILIES and \
            split_dscim_mode(cfg.dscim)[0] not in ("off", "float"):
        raise ValueError(f"DS-CIM serving ({cfg.dscim!r}) needs an "
                         "attention-family model; the "
                         f"{cfg.family!r} family serves 'off' and 'float' "
                         "only")


def _check_continuous(cfg: ArchConfig):
    """The continuous loops (the scheduler, the router, the watchdog's
    probe, the integrity layer) admit into a dense or paged attention
    cache slot by slot: an attention family only."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError("continuous batching needs an attention-family "
                         f"model, not {cfg.family!r}: serve {cfg.name} "
                         "through serve_batch")


def _make_sampler(sample: str):
    """Decode-rule factory: 'greedy' -> None (argmax, no generator);
    'temp:<t>' -> temperature sampling; 'topk:<k>[:<t>]' -> top-k with
    optional temperature; 'topp:<p>[:<t>]' -> nucleus sampling (keep the
    smallest prefix of the temperature-scaled distribution with cumulative
    probability >= p; 'topp:1.0:<t>' is 'temp:<t>').  The returned
    ``draw(key, logits)`` -> (B,) int32 is a Gumbel argmax over the masked
    logits with one uniform per logit, row b's drawn from
    ``counter_rng.uniforms`` under ``key`` = (seed (1,) or int, stream
    (B,), count (B,)): a function of (seed, stream[b], count[b]) only.
    The serving loops give each row its own stream and pass the number
    of tokens the row has emitted so far as its count."""
    if sample == "greedy":
        return None
    parts = sample.split(":")
    k = p = None
    if parts[0] == "temp" and len(parts) == 2:
        t = float(parts[1])
    elif parts[0] == "topk" and len(parts) in (2, 3):
        k = int(parts[1])
        t = float(parts[2]) if len(parts) == 3 else 1.0
    elif parts[0] == "topp" and len(parts) in (2, 3):
        p = float(parts[1])
        t = float(parts[2]) if len(parts) == 3 else 1.0
        if not 0.0 < p <= 1.0:
            raise ValueError(f"top-p must be in (0, 1], got {p}")
    else:
        raise ValueError(f"bad sample spec {sample!r}; want 'greedy', "
                         "'temp:<t>', 'topk:<k>[:<t>]' or 'topp:<p>[:<t>]'")
    if t <= 0:
        raise ValueError(f"temperature must be > 0, got {t}")
    return functools.partial(_draw, t=t, k=k, p=p)


def _mask_logits(logits, t: float, k=None, p=None):
    """Temperature-scaled f32 logits with the tokens outside the top-k
    (kept: >= the k-th value) or the nucleus (kept: the sorted tokens
    whose *exclusive* cumulative probability is < p, the top token always)
    set to -inf, as the reference masks them."""
    lg = logits.to(torch.float32) / t
    ninf = float("-inf")          # a scalar: no host-to-device copy
    if k is not None:
        kth = torch.topk(lg, k, dim=-1).values[..., -1:]
        lg = torch.where(lg >= kth, lg, ninf)
    if p is not None:
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        excl = torch.cumsum(probs, dim=-1) - probs
        # >= 1 on every healthy row; the clamp only keeps a NaN row's
        # gather in range (the degenerate-row guard replaces its draw)
        nkeep = (excl < p).sum(-1, keepdim=True).clamp_min(1)
        kth = torch.gather(srt, -1, nkeep - 1)
        lg = torch.where(lg >= kth, lg, ninf)
    return lg


def _row_keys(key):
    seed, stream, count = key
    h = counter_rng.mix(counter_rng.mix(0, seed), stream.to(torch.int64))
    return counter_rng.mix(h, count.to(torch.int64))


def _draw(key, logits, *, t: float, k=None, p=None):
    lg = _mask_logits(logits, t, k, p)
    # degenerate-row guard: a row whose masked logits hold a NaN, a +inf
    # or no finite entry falls back to greedy argmax over the NaN-cleaned
    # original logits; healthy rows draw from their untouched lg
    bad = torch.isnan(lg).any(-1) | torch.isposinf(lg).any(-1) \
        | ~torch.isfinite(lg).any(-1)
    lf = logits.to(torch.float32)
    clean = torch.where(torch.isnan(lf), float("-inf"), lf)
    greedy = torch.argmax(clean, dim=-1)
    safe = torch.where(bad[:, None], 0.0, lg)
    u = counter_rng.uniforms(_row_keys(key), safe.shape[-1])
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    drawn = torch.argmax(safe + gumbel, dim=-1)
    return torch.where(bad, greedy, drawn).to(torch.int32)


def _next_fn(sampler):
    """(logits, key) -> (B,) int32 token: greedy argmax, or one draw under
    ``key`` (``_make_sampler``; the same key in every loop, so the graph
    and the eager loop draw identically)."""
    if sampler is None:
        return lambda logits, key: torch.argmax(logits, dim=-1).to(
            torch.int32)
    return lambda logits, key: sampler(key, logits)


def _key(st, count):
    """The sample key of state ``st`` at per-row emitted counts."""
    return st["seed"], st["stream"], count


_SPEC_L = {"dscim1": 256, "dscim2": 64}   # the paper's two operating points


def _parse_spec(spec: str | None):
    """Self-speculative decoding spec: '<variant>:<k>' (e.g. 'dscim2:4')
    -> (draft_variant, k).  k = 0 (or None/'') disables speculation: the
    builders fall through to the plain loops, so 'dscim2:0' is the plain
    path, not a degenerate window."""
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) != 2 or parts[0] not in _SPEC_L:
        raise ValueError(f"bad spec {spec!r}; want 'dscim1:<k>' or "
                         "'dscim2:<k>', e.g. 'dscim2:4'")
    try:
        k = int(parts[1])
    except ValueError:
        raise ValueError(f"bad spec {spec!r}: draft depth {parts[1]!r} is "
                         "not an int") from None
    if k < 0:
        raise ValueError(f"spec draft depth must be >= 0, got {k}")
    return (parts[0], k) if k else None


def _draft_cfg(cfg: ArchConfig, variant: str) -> ArchConfig:
    """The drafter's config: same weights and architecture, the cheaper
    estimator.  Rewrites the serving dscim spec's variant and sample
    length (dscim2 -> L64, dscim1 -> L256), keeping mode[+attn] and
    calibration: the prepared int8 planes are shared by every estimator,
    so draft and verify serve the same resident weights.  'off'/'float'
    specs draft through themselves (every greedy draft is accepted)."""
    spec = getattr(cfg, "dscim", "off")
    if spec == "off" or split_dscim_mode(spec)[0] in ("off", "float"):
        return cfg
    parts = spec.split(":")
    parts[1] = variant
    parts[2] = str(_SPEC_L[variant])
    return dataclasses.replace(cfg, dscim=":".join(parts))


def _check_spec(cfg: ArchConfig, trace_logits: bool = False):
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError("speculative decoding needs a model family with a "
                         f"batched verify forward, not {cfg.family!r}")
    if cfg.stub_frontend:
        raise ValueError("speculative decoding needs token inputs; "
                         "stub-frontend configs are unsupported")
    if trace_logits:
        raise ValueError("trace_logits is a fixed-length-loop feature; "
                         "speculative windows keep logits off the path")


def _make_step(cfg: ArchConfig, st: dict, nxt, *, masked: bool, eos: int,
               par=None):
    """One decode step over the static state ``st``, in place: decode
    ``st["tok"]``, draw, write the token (and the logits / live / bad
    planes ``st`` carries) at row ``st["i"]``, advance ``i``.  ``masked``:
    done slots stay put, emit ``PAD_ID`` and their n_out stops; a slot
    finishes on ``eos`` or when n_out reaches max_new (tokens counted
    including the prefill token).  Unmasked is the fixed-length loop.
    Nothing reads back to the host.  ``par``: decode under that mesh."""
    decode = get_model(cfg).decode
    kw = _mesh_kw(par)

    def step():
        params = st["params"]
        tok, done, i = st["tok"], st["done"], st["i"]
        logits, _ = decode(params, cfg, tok, st["cache"],
                           done=done if masked else None, **kw)
        if "logits0" in st:                 # the segment's first logits
            st["logits0"].copy_(torch.where(i == 0, logits,
                                            st["logits0"]))
        if "live" in st:
            live = ~done
            st["live"].index_copy_(0, i, live[None])
            st["bad"].index_copy_(
                0, i, (live & ~torch.isfinite(logits).all(-1))[None])
        if "trace" in st:
            st["trace"].index_copy_(0, i, logits[None])
        new = nxt(logits, _key(st, st["n_out"]))
        if masked:
            new = torch.where(done, PAD_ID, new)
            st["n_out"].add_((~done).to(torch.int32))
            done.copy_(done | (new == eos) | (st["n_out"] >= st["max_new"]))
        else:
            st["n_out"].add_(1)
        tok.copy_(new)
        st["toks"].index_copy_(0, i, new[None])
        i.add_(1)

    return step


def _make_window(cfg: ArchConfig, cfg_draft: ArchConfig, st: dict, nxt,
                 k: int, eos: int, par=None):
    """One self-speculative draft/verify window over the static state
    ``st``, in place (the port of the reference's ``_make_spec_window``).

    Drafts k tokens greedily with ``cfg_draft``'s estimator (drafting
    draws nothing), rewinds ``pos`` and the paged tails to the window
    start, verifies the k+1-token window with one forward through
    ``cfg``'s estimator (``lm.decode_multi``), then folds the standard
    accept rule over the window: position t emits the token the
    *verifier* decides (argmax, or a draw keyed by the row's emitted
    count), and the window goes on past t only while the draft at t+1
    equals the emitted token.  Greedy emission is therefore bitwise what
    the plain loop emits; every live row emits at least one token a
    window.  ``kvcache.spec_rollback`` then truncates the cache to the
    last emitted position.  The draft's writes (a flush included, when a
    draft crosses a page boundary) land at positions the verify pass
    rewrites before it reads them; pages are never allocated here: the
    caller sizes every slot's grant with +k headroom.

    The returned ``window()`` updates ``tok``, ``done``, ``n_out`` and
    the cache, and returns (n_out at the window start (B,), em (B, k+1)
    emitted tokens (``PAD_ID`` where none), vm (B, k+1) emitted mask,
    bad (B, k+1) emitted from non-finite logits, the verify logits at
    position 0 (B, Vp)).  Nothing reads back to the host."""

    def window():
        params, cache = st["params"], st["cache"]
        tok, done, n_out = st["tok"], st["done"], st["n_out"]
        pos0 = cache["pos"].clone()
        paged = "k_pages" in cache
        tails0 = (cache["k_tail"].clone(), cache["v_tail"].clone()) \
            if paged else None
        cnt0 = n_out.clone()
        drafts, dtok = [], tok
        for _ in range(k):
            dlogits, _ = lm.decode(params, cfg_draft, dtok, cache, done=done,
                                   par=par)
            dtok = torch.argmax(dlogits, dim=-1).to(torch.int32)
            drafts.append(dtok)
        # rewind: the verify pass rewrites every draft write before it
        # reads it; a draft that crossed a page boundary also wrapped the
        # tail over committed entries below pos0 % ps, which verify reads
        cache["pos"].copy_(pos0)
        if paged:
            cache["k_tail"].copy_(tails0[0])
            cache["v_tail"].copy_(tails0[1])
        vlogits, _, win_kv = lm.decode_multi(
            params, cfg, torch.stack([tok] + drafts, dim=1), cache,
            done=done, par=par)
        acc, dn, nout, last = ~done, done.clone(), n_out.clone(), tok
        em, vm = [], []
        for t in range(k + 1):
            cand = nxt(vlogits[:, t], _key(st, nout))
            emit = acc
            tok_t = torch.where(emit, cand, PAD_ID)
            nout = nout + emit.to(torch.int32)
            stop = (tok_t == eos) | (nout >= st["max_new"])
            dn = dn | (emit & stop)
            if t < k:
                acc = emit & ~stop & (cand == drafts[t])
            last = torch.where(emit, cand, last)
            em.append(tok_t)
            vm.append(emit)
        em, vm = torch.stack(em, dim=1), torch.stack(vm, dim=1)
        bad = vm & ~torch.isfinite(vlogits).all(-1)
        n_emit = vm.sum(1).to(pos0.dtype)
        kvcache.spec_rollback(cache, pos0, pos0 + n_emit, tails0, win_kv)
        tok.copy_(last)
        done.copy_(dn)
        n_out.copy_(nout)
        return cnt0, em, vm, bad, vlogits[:, 0]

    return window


def _leaves(params):
    """Every tensor of a parameter tree (prepared weights' planes too, a
    placed leaf's piece)."""
    from ..parallel import Sharded
    out = []

    def visit(_, a):
        if isinstance(a, Sharded):
            a = a.local
        if isinstance(a, QuantizedLinearWeight):
            out.extend((a.q, a.scale))
        elif isinstance(a, torch.Tensor):
            out.append(a)
        return a
    map_params(visit, params)
    return out


def _at(tree, path: str):
    """The leaf of a nested dict at ``map_params``' 'a/b/c' path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _binding(*trees) -> tuple:
    """What a captured graph has baked in: every tensor's address, shape,
    strides and type.  A graph replays only for tensors with the same
    binding, which then hold what the graph reads."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for tree in trees for t in _leaves(tree))


def _prepare_fn(st: dict, uses, par=None):
    """The kernels' capture preparation for a step over ``st``: ``uses``
    lists the (cfg, M) pairs of the estimators the step runs and the rows
    each DS-CIM matmul sees (a speculative window runs the draft's at B
    rows and the verifier's at B and B*(k+1)).  Per estimator mode: the
    fused MVM for every prepared weight shape (``kernel``), the count
    kernel's tables (``bitmatmul``), the count LUT on the device
    (``lut``); paged attention for an int8 cache, at B rows.  Under a
    mesh (``par``) the prepared weights are the rank's pieces, and one
    eager collective on every group of the mesh sets NCCL's communicators
    up."""
    from ..kernels import dscim_fused, dscim_mvm, paged_attention
    from ..parallel import Sharded

    def prepare(stream):
        dev = st["tok"].device
        if par is not None:
            par.warm_up(dev)
        qws = []

        def visit(_, a):
            if isinstance(a, Sharded):
                a = a.local
            if isinstance(a, QuantizedLinearWeight):
                qws.append(a)
        map_params(visit, st["params"])
        first = [w[(0,) * len(w.stack)] if w.stack else w for w in qws]
        for cfg, M in uses:
            lin = lm._lin(cfg)
            if lin is None:
                continue
            if lin.mode == "lut":
                lin.macro.lut_table(dev)
            elif lin.mode == "bitmatmul":
                dscim_mvm.prepare_capture(lin.macro.folded, lin.cfg.k, M,
                                          dev, stream)
            elif lin.mode == "kernel":
                ws = first or _per_call_weights(cfg, st["params"],
                                                lin.group_k, par)
                dscim_fused.prepare_capture(ws, M, lin.cfg, stream)
        cache = st["cache"]
        if "k_pages" in cache:
            cfg = uses[0][0]
            ps, KV, HD = cache["k_pages"].shape[2:]
            # n_rep of q's padded heads, as the live call derives it
            paged_attention.prepare_capture(
                st["tok"].shape[0], KV, cfg.q_heads // KV, HD, ps,
                cache["page_table"].shape[1], cache["pos"].device, stream)

    return prepare


def _per_call_weights(cfg: ArchConfig, params, group_k, par=None) -> list:
    """The prepared weights a step on float params (``serve_batch(
    prepare=False)``) makes at each call, one layer's of each matrix, as
    the kernel sees them: on a mesh, this rank's N-slice
    (``dscim_fused_mvm_sharded``).  ``prepare_capture`` launches the fused
    MVM on each shape before the capture."""
    if par is not None:
        params = _whole_for_prepare(cfg, params, par)
    layer0 = map_params(lambda _, a: a[:1] if isinstance(a, torch.Tensor)
                        and a.ndim >= 3 else a, params)
    out = []

    def visit(_, qw):
        if not isinstance(qw, QuantizedLinearWeight):
            return qw
        if qw.stack:
            qw = qw[(0,) * len(qw.stack)]
        if par is not None and qw.n % par.tp_size == 0:
            from .sharding import qweight_specs, shard_for
            qw = shard_for(par.rank_coords,
                           qweight_specs(qw, par.tp_axis, par.sizes), qw)
            qw = QuantizedLinearWeight(qw.q.contiguous(),
                                       qw.scale.contiguous(), qw.k_orig,
                                       qw.group_k)
        out.append(qw)
        return qw
    map_params(visit, prepare_dscim_params(layer0, cfg, group_k=group_k))
    return out


def _uses(cfg: ArchConfig, B: int, spec):
    """``_prepare_fn``'s (cfg, M) pairs of a plain step or, under
    ``spec`` (parsed), a window."""
    if spec is None:
        return [(cfg, B)]
    return [(cfg, B), (cfg, B * (spec[1] + 1)),
            (_draft_cfg(cfg, spec[0]), B)]


def _static_cache(cfg: ArchConfig, B: int, capacity: int, kv: str,
                  page_size: int, n_pages: int | None, device,
                  integrity: bool = False, par=None):
    """An empty cache of the requested layout (the runners' and the serve
    state's static buffers); ``integrity`` adds the int8 pool's digest
    plane; ``par``: a recurrent family's state pieces on that mesh."""
    from ..core.kvcache import init_paged_cache, n_pages_for
    if cfg.family not in ATTENTION_FAMILIES:      # the family's own state
        return get_model(cfg).cache_specs(cfg, B, capacity, device=device,
                                          **_mesh_kw(par))
    if kv == "float":
        shape = (cfg.n_layers, B, capacity, cfg.n_kv, cfg.head_dim)
        cdt = lm.DTYPES[cfg.cache_dtype]
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device),
                "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
    mp = n_pages_for(capacity, page_size)
    return init_paged_cache(cfg.n_layers, B,
                            B * mp if n_pages is None else n_pages,
                            page_size, mp, cfg.n_kv, cfg.head_dim,
                            device=device, integrity=integrity)


class _GenerateRunner:
    """The static state of one-shot generation at one option set, and its
    captured step (a decode step, or under ``spec`` a draft/verify
    window).  Prefill (eager) copies into the static buffers; the graph
    binds the addresses of the params it was captured with
    (``_binding``) and is captured again when handed other tensors.  The
    runner holds the params only during a call."""

    def __init__(self, cfg, B, S, n_tokens, kv, page_size, eos_id, sample,
                 trace_logits, device, spec=None, par=None):
        self.cfg, self.n_tokens, self.kv = cfg, n_tokens, kv
        self.par = par
        self.page_size, self.eos_id = page_size, eos_id
        self.spec = sp = _parse_spec(spec)
        self.k = sp[1] if sp else 0
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        self.nxt = _next_fn(_make_sampler(sample))
        eos = -1 if eos_id is None else eos_id
        self.st = st = {
            "params": None,
            "tok": torch.zeros((B,), **i32),
            "done": torch.zeros((B,), dtype=torch.bool, device=dev),
            "n_out": torch.zeros((B,), **i32),
            "max_new": torch.zeros((B,), **i32),
            "i": torch.zeros((1,), dtype=torch.int64, device=dev),
            "cache": _static_cache(cfg, B, S + n_tokens + self.k, kv,
                                   page_size, None, dev, par=par),
            "seed": torch.zeros((1,), dtype=torch.int64, device=dev),
            "stream": torch.arange(B, dtype=torch.int64, device=dev)}
        if sp:
            # a padded column (n_tokens) takes the writes of positions
            # that emit nothing: torch has no dropping scatter
            st["toks"] = torch.zeros((B, n_tokens + 1), **i32)
            st["windows"] = torch.zeros((B,), **i32)
            window = _make_window(cfg, _draft_cfg(cfg, sp[0]), st, self.nxt,
                                  self.k, eos, par)

            def step():
                st["windows"].add_((~st["done"]).to(torch.int32))
                cnt0, em, vm, _, _ = window()
                cols = cnt0[:, None].long() + torch.arange(
                    self.k + 1, device=dev)[None, :]
                st["toks"].scatter_(1, torch.where(vm, cols, n_tokens), em)
        else:
            st["toks"] = torch.zeros((n_tokens, B), **i32)
            if trace_logits:
                st["trace"] = torch.zeros((n_tokens, B, cfg.vocab_padded),
                                          dtype=torch.float32, device=dev)
            step = _make_step(cfg, st, self.nxt, masked=eos_id is not None,
                              eos=eos, par=par)
        self.step = CapturedStep(step, dev, _prepare_fn(
            st, _uses(cfg, B, sp), par))
        self.bound = None

    def __call__(self, params, tokens, max_new, rng_seed: int,
                 graph: bool):
        key = _binding(params)
        if key != self.bound:               # other tensors: capture again
            self.step.graph = None
            self.bound = key
        self.st["params"] = params
        try:
            return self._generate(params, tokens, max_new, rng_seed, graph)
        finally:
            self.st["params"] = None

    def _generate(self, params, tokens, max_new, rng_seed, graph):
        st, cfg, n = self.st, self.cfg, self.n_tokens
        logits0, cache = self._prefill(params, tokens)
        map_params(lambda path, t: _at(st["cache"], path).copy_(t), cache)
        del cache
        st["seed"].fill_(rng_seed)
        st["n_out"].zero_()
        tok0 = self.nxt(logits0, _key(st, st["n_out"]))
        st["tok"].copy_(tok0)
        st["toks"].fill_(PAD_ID)
        if "trace" in st:
            st["trace"][0] = logits0
        st["n_out"].fill_(1)
        if max_new is None:
            st["max_new"].fill_(n)
        else:
            st["max_new"].copy_(torch.clamp_max(max_new, n))
        st["i"].fill_(1)
        run = self.step.run if graph else self.step.step
        eos = -1 if self.eos_id is None else self.eos_id
        if self.spec is None and self.eos_id is None:
            st["toks"][0] = tok0
            st["done"].zero_()
            for _ in range(n - 1):
                run()
        else:
            st["done"].copy_((tok0 == eos) | (st["max_new"] <= 1))
            if self.spec is None:
                st["toks"][0] = tok0
            else:
                st["toks"][:, 0] = tok0
                st["windows"].zero_()
            # done-masked steps and windows are inert: look at done on the
            # host every few replays only
            every = SEG_LEN if graph else 1
            for r in range(n - 1):
                if r % every == 0 and bool(st["done"].all()):
                    break
                run()
        if self.spec is None:
            out = st["toks"].T.contiguous()
            stats = None
        else:
            out = st["toks"][:, :n].contiguous()
            stats = {"windows": st["windows"].clone(),
                     "emitted": st["n_out"].clone()}
        logits = st["trace"].clone() if "trace" in st else logits0
        return out, logits, st["cache"], stats

    def _prefill(self, params, tokens):
        B, S = tokens.shape
        cfg, n = self.cfg, self.n_tokens + self.k
        kw = _mesh_kw(self.par)
        if self.kv == "float":
            return get_model(cfg).prefill(params, cfg, tokens,
                                          capacity=S + n, **kw)
        from ..core.kvcache import n_pages_for, paged_from_dense
        logits0, dense = lm.prefill(params, cfg, tokens, **kw)
        mp = n_pages_for(S + n, self.page_size)
        return logits0, paged_from_dense(dense["k"], dense["v"],
                                         self.page_size, n_pages=B * mp,
                                         max_pages=mp)


@functools.lru_cache(maxsize=8)
def _generate_runner(cfg, B, S, n_tokens, kv, page_size, eos_id, sample,
                     trace_logits, device, spec, par=None):
    """The one-shot runner of these options, made once.  Callers pass
    ``par`` only under a mesh, so a runner of one device has one key."""
    return _GenerateRunner(cfg, B, S, n_tokens, kv, page_size, eos_id,
                           sample, trace_logits, device, spec, par)


def graph_ok(dev, par) -> str | None:
    """Why a step on ``dev`` under mesh ``par`` runs eagerly where a graph
    was asked for, or None when it can be captured: no graphs off CUDA,
    and none over gloo (its collectives sync with the host)."""
    if dev.type != "cuda":
        return "no CUDA graphs off CUDA"
    if par is not None and not par.capturable:
        return (f"a {par.backend} group's collectives cannot be captured "
                "in a CUDA graph")
    return None


def make_generate_fn(cfg: ArchConfig, n_tokens: int = 16, *,
                     trace_logits: bool = False, eos_id: int | None = None,
                     kv: str = "float", page_size: int = 8,
                     sample: str = "greedy", scan: bool = True,
                     spec: str | None = None, par=None):
    """Generation: ``generate(params, tokens, max_new=None, rng_seed=0)``
    with tokens (B, S) int -> ``(out (B, n_tokens) int32, logits, cache)``.

    ``logits`` is the prefill last-token logits (B, Vp), or under
    ``trace_logits`` the stacked per-step trace (n_tokens, B, Vp)
    (fixed-length loop only).  ``cache`` is the final KV cache (the
    runner's static buffers: the next request at these options overwrites
    them).

    ``eos_id``: stop once every slot has emitted ``eos_id`` (or hit its
    optional ``max_new`` (B,) budget, counted including the prefill
    token); finished slots stop advancing and their remaining tokens are
    ``PAD_ID``.  ``sample``: 'greedy' or a ``_make_sampler`` spec, keyed
    by ``rng_seed`` (row b's stream is b).  ``kv``: 'float' dense cache
    or 'int8' block-paged cache (``page_size`` tokens per page, pool
    sized for prompt + generation).

    ``spec``: '<variant>:<k>' (e.g. 'dscim2:4') turns on self-speculative
    decoding: each replay is one draft/verify window (``_make_window``)
    and the KV allocation gains +k headroom for in-flight draft
    positions; the loop looks at ``done`` every ``SEG_LEN`` windows.
    Greedy output is bitwise the plain loop's; sampled output too, row
    by row, since a draw is keyed by the row's emitted count.
    ``generate.last_spec_stats`` is then ``{"windows": (B,), "emitted":
    (B,)}``: the windows each row took part in and the tokens it emitted
    (the accepted-tokens-per-verify numerator and denominator), else
    None.

    ``scan=True`` (default) replays the captured step on CUDA (looking at
    ``done`` every ``SEG_LEN`` replays under ``eos_id``) and runs it
    eagerly on the CPU; ``scan=False`` is the eager host loop.  Both give
    the same tokens and logits, bitwise.  The graph stays bound to the
    addresses of ``params``: handing the same prepared tensors again
    replays it, other tensors capture it again (``clear_graphs`` frees
    the runners).

    ``par``: generation under that mesh (``params`` placed by
    ``prepare_serving_params(..., par)``); every rank returns the same
    tokens.  Over gloo on CUDA the step runs eagerly
    (``generate.last_graph`` is False and ``generate.eager_reason`` says
    why)."""
    _check_kv(cfg, kv)
    _make_sampler(sample)                   # reject a bad spec up front
    if trace_logits and eos_id is not None:
        raise ValueError("trace_logits is a fixed-length-loop feature")
    if _parse_spec(spec) is not None:
        _check_spec(cfg, trace_logits)
    else:
        spec = None

    @torch.no_grad()
    def generate(params, tokens: torch.Tensor, max_new=None,
                 rng_seed: int = 0):
        B, S = tokens.shape
        runner = _generate_runner(cfg, B, S, n_tokens, kv, page_size,
                                  eos_id, sample, trace_logits,
                                  tokens.device, spec,
                                  *(() if par is None else (par,)))
        captures = runner.step.captures
        why = graph_ok(tokens.device, par)
        graph = scan and why is None
        generate.last_graph = graph
        generate.eager_reason = why if scan and tokens.device.type == \
            "cuda" else None
        out, logits, cache, stats = runner(
            params, tokens, max_new, rng_seed, graph)
        generate.last_capture_s = runner.step.capture_s \
            if runner.step.captures != captures else None
        generate.last_spec_stats = stats
        return out, logits, cache

    generate.last_capture_s = None   # capture time of the last call, if any
    generate.last_spec_stats = None
    generate.last_graph = None       # whether the last call replayed a graph
    generate.eager_reason = None     # why a graph asked for ran eagerly
    return generate


def clear_graphs() -> None:
    """Drop every one-shot runner: its captured graph, graph memory pool
    and static buffers.  The next request at any option set captures
    again."""
    _generate_runner.cache_clear()


# ---------------------------------------------------------------------------
# continuous batching: admit / segment halves of the scheduler
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ArchConfig, slots: int, capacity: int, *,
                     kv: str = "float", page_size: int = 8,
                     n_pages: int | None = None, seed: int = 0,
                     integrity: bool = False, device=None):
    """Idle scheduler state: every slot free (done), an empty KV cache of
    the requested layout and the sampler's key: ``seed`` and a stream per
    slot, which each admission sets to the admission's number (so every
    request draws its own stream, whatever slot it lands in).
    ``capacity`` is the per-slot token budget (prompt + generated, + k
    under speculative decoding); for ``kv='int8'`` the page pool defaults
    to slots x pages-per-sequence and can be sized independently
    (``n_pages``).  ``integrity=True`` (int8 only) adds the per-page
    digest plane (core/kvcache.py ``page_sum``), which the admissions,
    segments and extend chunks keep current.  Admissions and segments
    update these tensors in place, so a captured segment step keeps its
    addresses."""
    _check_kv(cfg, kv)
    _check_continuous(cfg)
    if integrity and kv != "int8":
        raise ValueError("integrity checksums need the int8 paged cache "
                         "(kv='int8')")
    from ..device import resolve_device
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {"tok": torch.zeros((slots,), **i32),
            "done": torch.ones((slots,), dtype=torch.bool, device=dev),
            "n_out": torch.zeros((slots,), **i32),
            "max_new": torch.ones((slots,), **i32),
            "cache": _static_cache(cfg, slots, capacity, kv, page_size,
                                   n_pages, dev, integrity),
            "seed": torch.full((1,), seed, dtype=torch.int64, device=dev),
            "stream": torch.zeros((slots,), dtype=torch.int64, device=dev),
            "admitted": 0}


@functools.lru_cache(maxsize=16)
def make_admit_fn(cfg: ArchConfig, *, eos_id: int | None = None,
                  sample: str = "greedy", par=None):
    """One request admission: prefill a (1, S) prompt (eagerly), write its
    KV into free slot ``slot`` of the live cache (dense row overwrite, or
    the host-granted physical pages ``page_ids`` of the paged layout),
    give the slot the next stream, and seed its first token (its draw 0),
    budget and done flag.  Runs between segments; writes in place.
    ``par``: the prefill under that mesh."""
    nxt = _next_fn(_make_sampler(sample))
    eos = -1 if eos_id is None else eos_id
    kw = _mesh_kw(par)

    @torch.no_grad()
    def admit(params, state, prompt, slot: int, page_ids, max_new: int):
        logits0, dense = lm.prefill(params, cfg, prompt, **kw)
        state["stream"][slot] = state["admitted"]
        state["admitted"] += 1
        stream = state["stream"][slot:slot + 1]
        tok0 = nxt(logits0, (state["seed"], stream,
                             torch.zeros_like(stream)))[0]
        cache = state["cache"]
        if "k_pages" in cache:
            kvcache.admit_request(cache, dense["k"], dense["v"], slot,
                                  page_ids)
        else:
            kvcache.admit_dense(cache, dense["k"], dense["v"], slot)
        state["tok"][slot] = tok0
        state["done"][slot] = (tok0 == eos) | (max_new <= 1)
        state["n_out"][slot] = 1
        state["max_new"][slot] = max_new
        return state, tok0

    return admit


class _SegmentRun:
    """A segment's static outputs and captured step (a decode step, or
    under ``spec`` a draft/verify window), bound to one serve state and
    one set of params.  Its outputs have ``seg_len * (k+1)`` rows (k = 0
    without spec): window w's k+1 positions at rows w*(k+1) + t,
    chronologically, non-emitted positions dead (``live`` False, token
    ``PAD_ID``)."""

    def __init__(self, cfg, state, params, seg_len, nxt, eos, spec,
                 par=None):
        dev = state["tok"].device
        B = state["tok"].shape[0]
        k = spec[1] if spec else 0
        rows = seg_len * (k + 1)
        self.st = st = dict(state, params=params)
        st.update(
            i=torch.zeros((1,), dtype=torch.int64, device=dev),
            toks=torch.zeros((rows, B), dtype=torch.int32, device=dev),
            live=torch.zeros((rows, B), dtype=torch.bool, device=dev),
            bad=torch.zeros((rows, B), dtype=torch.bool, device=dev),
            logits0=torch.zeros((B, cfg.vocab_padded), dtype=torch.float32,
                                device=dev))
        if spec:
            window = _make_window(cfg, _draft_cfg(cfg, spec[0]), st, nxt, k,
                                  eos, par)
            offs = torch.arange(k + 1, device=dev)

            def step():
                i = st["i"]
                _, em, vm, bad, l0 = window()
                st["logits0"].copy_(torch.where(i == 0, l0, st["logits0"]))
                at = i * (k + 1) + offs
                st["toks"].index_copy_(0, at, em.T)
                st["live"].index_copy_(0, at, vm.T)
                st["bad"].index_copy_(0, at, bad.T)
                i.add_(1)
        else:
            step = _make_step(cfg, st, nxt, masked=True, eos=eos, par=par)
        self.step = CapturedStep(step, dev,
                                 _prepare_fn(st, _uses(cfg, B, spec), par))


def make_segment_fn(cfg: ArchConfig, seg_len: int = SEG_LEN, *,
                    eos_id: int | None = None, sample: str = "greedy",
                    graph: bool = True, spec: str | None = None,
                    par=None):
    """One continuous-batching segment: ``seg_len`` done-masked decode
    steps over the whole slot batch, as replays of the captured step on
    CUDA (eager steps on the CPU).  Slots finish on EOS or their budget
    and stop advancing; the scheduler admits new requests into freed
    slots *between* segments.  ``segment(params, state)`` returns (state,
    toks (rows, B) int32, live (rows, B) bool, aux) where ``live[s, b]``
    marks that slot b did useful work at row s; ``aux["bad"]`` (rows, B)
    flags live rows whose logits went NaN/Inf and ``aux["logits0"]`` (B,
    Vp) f32 is the first step's logits, as in the reference (the
    accuracy watchdog's serving side).  With the cache's digest plane
    the pages the segment flushed are re-digested after the replays.
    rows is
    ``seg_len``, or under ``spec`` ('<variant>:<k>') ``seg_len * (k+1)``:
    each step is then a draft/verify window, ``aux["logits0"]`` the first
    window's verify logits at position 0.  The captured graph binds the
    state and the params it last ran on, and is captured again for
    others; the function holds them (and the graph) until it is dropped,
    so it is made per serving run and not cached.  ``graph=False`` runs
    the same step eagerly on CUDA too (the A/B baseline).  ``par``: the
    step under that mesh; over gloo on CUDA it runs eagerly
    (``segment.eager_reason`` says why)."""
    nxt = _next_fn(_make_sampler(sample))
    eos = -1 if eos_id is None else eos_id
    sp = _parse_spec(spec)
    if sp:
        _check_spec(cfg)
    box = {"bindings": 0}

    k = sp[1] if sp else 0

    @torch.no_grad()
    def segment(params, state):
        run = _bound_run(box, params, state, lambda: _SegmentRun(
            cfg, state, params, seg_len, nxt, eos, sp, par))
        st = run.st
        st["i"].zero_()
        cache = state["cache"]
        sums = kvcache.CHECKSUM_KEY in cache
        pos0 = cache["pos"].clone() if sums else None
        why = graph_ok(run.step.device, par)
        if graph and why is not None and run.step.device.type == "cuda":
            segment.eager_reason = why
        step = run.step.run if graph and why is None else run.step.step
        for _ in range(seg_len):
            step()
        if sums:
            # a draft may flush up to k positions past the committed pos
            kvcache.refresh_page_checksums(cache, pos0, cache["pos"] + k,
                                           seg_len * (k + 1) + k)
        return state, st["toks"].clone(), st["live"].clone(), \
            {"bad": st["bad"].clone(), "logits0": st["logits0"].clone()}

    segment.runs = box      # the current binding and the count of bindings
    segment.eager_reason = None
    return segment


def _bound_run(box: dict, params, state, make):
    """The runner in ``box`` if it is bound to ``params`` and the state's
    tensors, else a new one from ``make()`` (its graph is captured at its
    first replay); ``box["bindings"]`` counts the runners made."""
    key = _binding(params, {k: v for k, v in state.items()
                            if isinstance(v, (torch.Tensor, dict))})
    run = box.get("run")
    if run is None or box["key"] != key:
        run = make()
        box.update(run=run, key=key, bindings=box["bindings"] + 1)
    return run


class _ExtendRun:
    """One chunk of one slot's prompt over the serve state, as a captured
    step.  Its inputs (the chunk's tokens, the slot, the real length, the
    emit flag, the budget and the admission number) and outputs (the
    first token, the chunk's logits) are static tensors of the runner,
    not of the state, so the segment step's binding never sees them."""

    def __init__(self, cfg, state, params, chunk_len, nxt, eos,
                 trace_logits, par=None):
        dev = state["tok"].device
        B = state["tok"].shape[0]
        i32 = dict(dtype=torch.int32, device=dev)
        self.st = st = dict(state, params=params)
        st.update(
            x_toks=torch.zeros((1, chunk_len), dtype=torch.long, device=dev),
            x_slot=torch.zeros((1,), dtype=torch.long, device=dev),
            x_n_real=torch.ones((1,), **i32),
            x_emit=torch.zeros((1,), dtype=torch.bool, device=dev),
            x_max_new=torch.ones((1,), **i32),
            x_admitted=torch.zeros((1,), dtype=torch.int64, device=dev),
            x_tok0=torch.zeros((1,), **i32))
        if trace_logits:
            st["x_trace"] = torch.zeros((chunk_len, cfg.vocab_padded),
                                        dtype=torch.float32, device=dev)
        rows = torch.arange(B, device=dev)

        def step():
            cache, slot = st["cache"], st["x_slot"]
            is_t = rows == slot
            tokens = torch.where(is_t[:, None], st["x_toks"], 0)
            pos0 = cache["pos"].clone()
            tails0 = (cache["k_tail"].clone(), cache["v_tail"].clone()) \
                if "k_pages" in cache else None
            logits, _, win_kv = lm.decode_multi(st["params"], cfg, tokens,
                                                cache, done=~is_t, par=par)
            new_pos = pos0 + torch.where(is_t, st["x_n_real"], 0)
            kvcache.spec_rollback(cache, pos0, new_pos, tails0, win_kv)
            lg_t = logits.index_select(0, slot)[0]             # (T, Vp)
            if "x_trace" in st:
                st["x_trace"].copy_(lg_t)
            lg = lg_t.index_select(0, (st["x_n_real"] - 1).long())
            emit = st["x_emit"]
            stream = torch.where(emit, st["x_admitted"],
                                 st["stream"].index_select(0, slot))
            st["stream"].index_copy_(0, slot, stream)
            tok0 = nxt(lg, (st["seed"], stream, torch.zeros_like(stream)))
            st["x_tok0"].copy_(tok0)
            max_new = st["x_max_new"]
            for name, val in (
                    ("tok", tok0), ("n_out", 1), ("max_new", max_new),
                    ("done", (tok0 == eos) | (max_new <= 1))):
                old = True if name == "done" \
                    else st[name].index_select(0, slot)
                st[name].index_copy_(0, slot, torch.where(emit, val, old))
        uses = [(cfg, B), (cfg, B * chunk_len)]
        self.step = CapturedStep(step, dev, _prepare_fn(st, uses, par))


def make_extend_fn(cfg: ArchConfig, chunk_len: int, *,
                   eos_id: int | None = None, sample: str = "greedy",
                   trace_logits: bool = False, graph: bool = True,
                   par=None):
    """One chunked-prefill step (the port of the reference's
    ``make_extend_fn``): feed ``chunk_len`` prompt tokens of ONE slot
    through the batched verify forward (``models/lm.py decode_multi``)
    with every other slot done-masked (frozen position, no writes), then
    roll the window back to the chunk's real length
    (``core/kvcache.py spec_rollback``).  A prompt of length S is
    admitted as ceil(S / chunk_len) calls of one captured graph (on the
    card; eager steps on the CPU or with ``graph=False``).  The slot's KV
    at ``pos .. pos+n_real-1`` is then what ``n_real`` teacher-forced
    single-token decodes would write.  A padded last chunk's pad
    positions sit causally after every real one; their writes are rolled
    back, and the page a padded flush may fill with garbage sits at
    logical index >= the committed position, where the tail overlay hides
    it until a later whole-page flush rewrites it.

    ``extend(params, state, toks (1, chunk_len) int, slot, n_real, emit,
    max_new) -> (state, tok0)``, the scalars as ints: writes the chunk's
    KV for ``slot`` in place; under ``emit`` (the last chunk) also gives
    the slot the admission number ``state["admitted"]`` as its stream,
    draws the first output token from the last real position's logits
    keyed (seed, stream, 0) as ``make_admit_fn`` draws it, and arms the
    slot (tok, done, n_out = 1, max_new).  A non-emitting call leaves the
    slot done-masked, so segments between chunks skip it.  The slot's
    page-table row must already hold its granted pages.  Inside the call
    nothing reads back to the host: the slot's logits row is picked by
    device indexing.  ``trace_logits=True`` also returns the slot's
    chunk logits (chunk_len, Vp) f32, pad positions included.

    The graph binds the state and the params it last ran on, like
    ``make_segment_fn``'s; ``extend.runs["bindings"]`` counts its
    bindings and ``extend.launches`` the kernel launches its calls made
    (counter name -> launches).  ``par``: the chunk under that mesh
    (eagerly over gloo on CUDA)."""
    from ..kernels import build
    _check_spec(cfg)
    nxt = _next_fn(_make_sampler(sample))
    eos = -1 if eos_id is None else eos_id
    box = {"bindings": 0}
    launches: dict = {}

    @torch.no_grad()
    def extend(params, state, toks, slot: int, n_real: int, emit: bool,
               max_new: int):
        run = _bound_run(box, params, state, lambda: _ExtendRun(
            cfg, state, params, chunk_len, nxt, eos, trace_logits, par))
        st = run.st
        st["x_toks"].copy_(torch.as_tensor(toks).reshape(1, -1))
        st["x_slot"].fill_(int(slot))
        st["x_n_real"].fill_(int(n_real))
        st["x_emit"].fill_(bool(emit))
        st["x_max_new"].fill_(int(max_new))
        st["x_admitted"].fill_(state["admitted"])
        step = run.step
        use_graph = graph and graph_ok(step.device, par) is None
        if use_graph and step.graph is None:
            step.capture()     # its preparation launches are not the step's
        cache = state["cache"]
        pos0 = cache["pos"].clone() \
            if kvcache.CHECKSUM_KEY in cache else None
        before = {c: c.count for c in build.COUNTERS}
        (step.run if use_graph else step.step)()
        for c in build.COUNTERS:
            if c.count != before.get(c, 0):
                launches[c.name] = launches.get(c.name, 0) \
                    + c.count - before.get(c, 0)
        if pos0 is not None:
            # the chunk, pad positions included, may have flushed pages up
            # to chunk_len past the slot's entry position
            span = torch.zeros_like(pos0)
            span[int(slot)] = chunk_len
            kvcache.refresh_page_checksums(cache, pos0, pos0 + span,
                                           chunk_len)
        if emit:
            state["admitted"] += 1
        tok0 = st["x_tok0"][0].clone()
        if trace_logits:
            return state, tok0, st["x_trace"].clone()
        return state, tok0

    extend.runs = box
    extend.launches = launches
    return extend


class _ProbeRun:
    """The probe's scratch buffers and captured step, bound to one serve
    state and one set of params (see ``make_probe_fn``)."""

    def __init__(self, cfg, state, params, par=None):
        cache = state["cache"]
        dev = state["tok"].device
        B = state["tok"].shape[0]
        rows = torch.arange(B, device=dev)
        scratch = dict(cache, pos=torch.empty_like(cache["pos"]))
        paged = "k_pages" in cache
        names = ("k_pages", "v_pages", "k_scale", "v_scale") if paged \
            else ("k", "v")
        if paged:
            ps = cache["k_pages"].shape[2]
            for name in ("k_tail", "v_tail"):
                scratch[name] = torch.empty_like(cache[name])
        saved = {name: torch.empty((cache[name].shape[0], B,
                                    *cache[name].shape[2 + (not paged):]),
                                   dtype=cache[name].dtype, device=dev)
                 for name in names}
        self.out = out = torch.zeros((B, cfg.vocab_padded),
                                     dtype=torch.float32, device=dev)

        def step():
            pos = cache["pos"]
            scratch["pos"].copy_(pos)
            if paged:
                for name in ("k_tail", "v_tail"):
                    scratch[name].copy_(cache[name])
                # the one page per slot a decode step can flush into
                at = (slice(None), cache["page_table"][
                    rows, (pos // ps).long()].long())
            else:
                at = (slice(None), rows,
                      torch.clamp_max(pos, cache["k"].shape[2] - 1).long())
            for name in names:
                saved[name].copy_(cache[name][at])
            logits, _ = lm.decode(params, cfg, state["tok"], scratch,
                                  done=state["done"], par=par)
            for name in names:
                cache[name][at] = saved[name]
            out.copy_(logits)

        st = {"params": params, "tok": state["tok"], "cache": cache}
        self.step = CapturedStep(step, dev, _prepare_fn(st, [(cfg, B)],
                                                        par))


def make_probe_fn(cfg_ref: ArchConfig, *, graph: bool = True, par=None):
    """The exact half of the accuracy watchdog's probe (the port of the
    reference's ``make_probe_fn``): one decode of the serve state's
    (token, cache) under ``cfg_ref``, normally the serving spec's
    exact-mode, fault-free twin (runtime/serving.py ``exact_probe_spec``,
    ``dscim_fault=''``), on the same prepared planes: the exact mode takes
    them too, so only the estimator differs.  ``probe(params, state) ->
    logits (B, Vp) f32``, compared with the segment's ``aux["logits0"]``.

    The port's decode writes in place, so the probe decodes a scratch
    cache: its own ``pos`` and tails, and the live pool, whose one page
    per slot that the step can flush is saved first and written back
    after (the dense layout: the row at ``pos``).  The serve state is
    bitwise what it was after a probe.  Like a segment, the probe is one
    captured graph on the card (eager on the CPU, or with
    ``graph=False``), bound to the state and params it last ran on;
    ``probe.runs["bindings"]`` counts its bindings.  Nothing reads back
    to the host.  ``par``: the probe under that mesh (eagerly over gloo
    on CUDA)."""
    box = {"bindings": 0}

    @torch.no_grad()
    def probe(params, state):
        run = _bound_run(box, params, state,
                         lambda: _ProbeRun(cfg_ref, state, params, par))
        use_graph = graph and graph_ok(run.step.device, par) is None
        (run.step.run if use_graph else run.step.step)()
        return run.out.clone()

    probe.runs = box
    return probe
