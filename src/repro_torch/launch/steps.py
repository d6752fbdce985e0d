"""Serving steps (port of ``prepare_serving_params``, the sampler,
``make_generate_fn`` and the continuous-batching halves
``init_serve_state`` / ``make_admit_fn`` / ``make_segment_fn`` from
``repro/launch/steps.py``).

``prepare_serving_params`` converts every DS-CIM-eligible weight once into
resident int8 ``QuantizedLinearWeight`` planes.

The reference runs its generation loop inside one jitted ``lax.scan`` /
``while_loop``, with the cache in the loop carry.  Here one done-masked
decode step (``_make_step``: decode, draw, done/budget update, the token
written to column ``i`` of a static output, ``i`` a device counter) reads
and writes only static tensors in place, and ``launch/graph.py
CapturedStep`` captures it once as a CUDA graph and replays it.  The
same step serves:

* ``make_generate_fn`` (one-shot requests): prefill eagerly, copy the cache
  into the runner's static buffers, then replay the step ``n_tokens - 1``
  times; the EOS loop looks at ``done`` on the host once every
  ``SEG_LEN`` replays only (done-masked steps are inert, so the tokens are those of a
  loop that stops at once).  ``scan=False`` is the eager host loop, one
  step and one ``done`` check per token: the A/B baseline.
* ``make_segment_fn`` (continuous batching): ``seg_len`` replays over the
  persistent serve state, between which ``make_admit_fn`` prefills new
  requests into freed slots.

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
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..configs.base import ArchConfig
from ..core import counter_rng, kvcache
from ..core.qweights import (QuantizedLinearWeight, map_params,
                             prepare_dscim_params, split_dscim_mode)
from ..models import lm
from .graph import CapturedStep

__all__ = ["prepare_serving_params", "make_generate_fn", "init_serve_state",
           "make_admit_fn", "make_segment_fn", "clear_graphs", "PAD_ID"]

PAD_ID = 0          # token written for finished slots
SEG_LEN = 4         # replays between two host looks at ``done``


def prepare_serving_params(cfg: ArchConfig, params):
    """Quantize-once weight preparation for DS-CIM serving; a no-op for
    'off'/'float' specs."""
    spec = getattr(cfg, "dscim", "off")
    if split_dscim_mode(spec)[0] in ("off", "float"):
        return params
    lin = lm._linear_for(spec)
    return prepare_dscim_params(params, cfg,
                                group_k=lin.group_k if lin else 128)


def _check_kv(cfg: ArchConfig, kv: str):
    if kv not in ("float", "int8"):
        raise ValueError(f"kv must be 'float' or 'int8', got {kv!r}")
    if cfg.family != "dense":
        raise ValueError(f"{cfg.family!r} models are not ported yet")


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
    if cfg.family != "dense":
        raise ValueError("speculative decoding needs a model family with a "
                         f"batched verify forward, not {cfg.family!r}")
    if cfg.stub_frontend:
        raise ValueError("speculative decoding needs token inputs; "
                         "stub-frontend configs are unsupported")
    if trace_logits:
        raise ValueError("trace_logits is a fixed-length-loop feature; "
                         "speculative windows keep logits off the path")


def _make_step(cfg: ArchConfig, st: dict, nxt, *, masked: bool, eos: int):
    """One decode step over the static state ``st``, in place: decode
    ``st["tok"]``, draw, write the token (and the logits / live / bad
    planes ``st`` carries) at row ``st["i"]``, advance ``i``.  ``masked``:
    done slots stay put, emit ``PAD_ID`` and their n_out stops; a slot
    finishes on ``eos`` or when n_out reaches max_new (tokens counted
    including the prefill token).  Unmasked is the fixed-length loop.
    Nothing reads back to the host."""

    def step():
        params = st["params"]
        tok, done, i = st["tok"], st["done"], st["i"]
        logits, _ = lm.decode(params, cfg, tok, st["cache"],
                              done=done if masked else None)
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
                 k: int, eos: int):
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
            dlogits, _ = lm.decode(params, cfg_draft, dtok, cache, done=done)
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
            done=done)
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
    """Every tensor of a parameter tree (prepared weights' planes too)."""
    out = []

    def visit(_, a):
        if isinstance(a, QuantizedLinearWeight):
            out.extend((a.q, a.scale))
        elif isinstance(a, torch.Tensor):
            out.append(a)
        return a
    map_params(visit, params)
    return out


def _binding(*trees) -> tuple:
    """What a captured graph has baked in: every tensor's address, shape,
    strides and type.  A graph replays only for tensors with the same
    binding, which then hold what the graph reads."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for tree in trees for t in _leaves(tree))


def _prepare_fn(st: dict, uses):
    """The kernels' capture preparation for a step over ``st``: ``uses``
    lists the (cfg, M) pairs of the estimators the step runs and the rows
    each DS-CIM matmul sees (a speculative window runs the draft's at B
    rows and the verifier's at B and B*(k+1)).  Per estimator mode: the
    fused MVM for every prepared weight shape (``kernel``), the count
    kernel's tables (``bitmatmul``), the count LUT on the device
    (``lut``); paged attention for an int8 cache, at B rows."""
    from ..kernels import dscim_fused, dscim_mvm, paged_attention

    def prepare(stream):
        dev = st["tok"].device
        qws = []
        map_params(lambda _, a: qws.append(a) if isinstance(
            a, QuantizedLinearWeight) else None, st["params"])
        first = [w[(0,) * len(w.stack)] if w.stack else w for w in qws]
        for cfg, M in uses:
            lin = lm._linear_for(cfg.dscim)
            if lin is None:
                continue
            if lin.mode == "lut":
                lin.macro.lut_table(dev)
            elif lin.mode == "bitmatmul":
                dscim_mvm.prepare_capture(lin.macro.folded, lin.cfg.k, M,
                                          dev, stream)
            elif lin.mode == "kernel" and first:
                dscim_fused.prepare_capture(first, M, lin.cfg, stream)
        cache = st["cache"]
        if "k_pages" in cache:
            cfg = uses[0][0]
            ps, KV, HD = cache["k_pages"].shape[2:]
            paged_attention.prepare_capture(
                st["tok"].shape[0], KV, cfg.n_heads // KV, HD, ps,
                cache["page_table"].shape[1], cache["pos"].device, stream)

    return prepare


def _uses(cfg: ArchConfig, B: int, spec):
    """``_prepare_fn``'s (cfg, M) pairs of a plain step or, under
    ``spec`` (parsed), a window."""
    if spec is None:
        return [(cfg, B)]
    return [(cfg, B), (cfg, B * (spec[1] + 1)),
            (_draft_cfg(cfg, spec[0]), B)]


def _static_cache(cfg: ArchConfig, B: int, capacity: int, kv: str,
                  page_size: int, n_pages: int | None, device):
    """An empty cache of the requested layout (the runners' and the serve
    state's static buffers)."""
    from ..core.kvcache import init_paged_cache, n_pages_for
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
                            device=device)


class _GenerateRunner:
    """The static state of one-shot generation at one option set, and its
    captured step (a decode step, or under ``spec`` a draft/verify
    window).  Prefill (eager) copies into the static buffers; the graph
    binds the addresses of the params it was captured with
    (``_binding``) and is captured again when handed other tensors.  The
    runner holds the params only during a call."""

    def __init__(self, cfg, B, S, n_tokens, kv, page_size, eos_id, sample,
                 trace_logits, device, spec=None):
        self.cfg, self.n_tokens, self.kv = cfg, n_tokens, kv
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
                                   page_size, None, dev),
            "seed": torch.zeros((1,), dtype=torch.int64, device=dev),
            "stream": torch.arange(B, dtype=torch.int64, device=dev)}
        if sp:
            # a padded column (n_tokens) takes the writes of positions
            # that emit nothing: torch has no dropping scatter
            st["toks"] = torch.zeros((B, n_tokens + 1), **i32)
            st["windows"] = torch.zeros((B,), **i32)
            window = _make_window(cfg, _draft_cfg(cfg, sp[0]), st, self.nxt,
                                  self.k, eos)

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
                              eos=eos)
        self.step = CapturedStep(step, dev, _prepare_fn(st, _uses(cfg, B,
                                                                  sp)))
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
        for name, t in cache.items():
            st["cache"][name].copy_(t)
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
        if self.kv == "float":
            return lm.prefill(params, cfg, tokens, capacity=S + n)
        from ..core.kvcache import n_pages_for, paged_from_dense
        logits0, dense = lm.prefill(params, cfg, tokens)
        mp = n_pages_for(S + n, self.page_size)
        return logits0, paged_from_dense(dense["k"], dense["v"],
                                         self.page_size, n_pages=B * mp,
                                         max_pages=mp)


@functools.lru_cache(maxsize=8)
def _generate_runner(cfg, B, S, n_tokens, kv, page_size, eos_id, sample,
                     trace_logits, device, spec):
    return _GenerateRunner(cfg, B, S, n_tokens, kv, page_size, eos_id,
                           sample, trace_logits, device, spec)


def make_generate_fn(cfg: ArchConfig, n_tokens: int = 16, *,
                     trace_logits: bool = False, eos_id: int | None = None,
                     kv: str = "float", page_size: int = 8,
                     sample: str = "greedy", scan: bool = True,
                     spec: str | None = None):
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
    the runners)."""
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
                                  tokens.device, spec)
        captures = runner.step.captures
        out, logits, cache, stats = runner(
            params, tokens, max_new, rng_seed,
            scan and tokens.device.type == "cuda")
        generate.last_capture_s = runner.step.capture_s \
            if runner.step.captures != captures else None
        generate.last_spec_stats = stats
        return out, logits, cache

    generate.last_capture_s = None   # capture time of the last call, if any
    generate.last_spec_stats = None
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
    (``n_pages``).  Admissions and segments update these tensors in
    place, so a captured segment step keeps its addresses."""
    _check_kv(cfg, kv)
    if integrity:
        raise NotImplementedError("the page checksum plane is not ported "
                                  "yet (ROADMAP A11)")
    from ..device import resolve_device
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {"tok": torch.zeros((slots,), **i32),
            "done": torch.ones((slots,), dtype=torch.bool, device=dev),
            "n_out": torch.zeros((slots,), **i32),
            "max_new": torch.ones((slots,), **i32),
            "cache": _static_cache(cfg, slots, capacity, kv, page_size,
                                   n_pages, dev),
            "seed": torch.full((1,), seed, dtype=torch.int64, device=dev),
            "stream": torch.zeros((slots,), dtype=torch.int64, device=dev),
            "admitted": 0}


@functools.lru_cache(maxsize=16)
def make_admit_fn(cfg: ArchConfig, *, eos_id: int | None = None,
                  sample: str = "greedy"):
    """One request admission: prefill a (1, S) prompt (eagerly), write its
    KV into free slot ``slot`` of the live cache (dense row overwrite, or
    the host-granted physical pages ``page_ids`` of the paged layout),
    give the slot the next stream, and seed its first token (its draw 0),
    budget and done flag.  Runs between segments; writes in place."""
    nxt = _next_fn(_make_sampler(sample))
    eos = -1 if eos_id is None else eos_id

    @torch.no_grad()
    def admit(params, state, prompt, slot: int, page_ids, max_new: int):
        logits0, dense = lm.prefill(params, cfg, prompt)
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

    def __init__(self, cfg, state, params, seg_len, nxt, eos, spec):
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
                                  eos)
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
            step = _make_step(cfg, st, nxt, masked=True, eos=eos)
        self.step = CapturedStep(step, dev,
                                 _prepare_fn(st, _uses(cfg, B, spec)))


def make_segment_fn(cfg: ArchConfig, seg_len: int = SEG_LEN, *,
                    eos_id: int | None = None, sample: str = "greedy",
                    graph: bool = True, spec: str | None = None):
    """One continuous-batching segment: ``seg_len`` done-masked decode
    steps over the whole slot batch, as replays of the captured step on
    CUDA (eager steps on the CPU).  Slots finish on EOS or their budget
    and stop advancing; the scheduler admits new requests into freed
    slots *between* segments.  ``segment(params, state)`` returns (state,
    toks (rows, B) int32, live (rows, B) bool, aux) where ``live[s, b]``
    marks that slot b did useful work at row s; ``aux["bad"]`` (rows, B)
    flags live rows whose logits went NaN/Inf and ``aux["logits0"]`` (B,
    Vp) f32 is the first step's logits, as in the reference.  rows is
    ``seg_len``, or under ``spec`` ('<variant>:<k>') ``seg_len * (k+1)``:
    each step is then a draft/verify window, ``aux["logits0"]`` the first
    window's verify logits at position 0.  The captured graph binds the
    state and the params it last ran on, and is captured again for
    others; the function holds them (and the graph) until it is dropped,
    so it is made per serving run and not cached.  ``graph=False`` runs
    the same step eagerly on CUDA too (the A/B baseline)."""
    nxt = _next_fn(_make_sampler(sample))
    eos = -1 if eos_id is None else eos_id
    sp = _parse_spec(spec)
    if sp:
        _check_spec(cfg)
    box = {}

    @torch.no_grad()
    def segment(params, state):
        key = _binding(params, {k: v for k, v in state.items()
                                if isinstance(v, (torch.Tensor, dict))})
        run = box.get("run")
        if run is None or box["key"] != key:
            run = _SegmentRun(cfg, state, params, seg_len, nxt, eos, sp)
            box.update(run=run, key=key)
        st = run.st
        st["i"].zero_()
        step = run.step.run if graph else run.step.step
        for _ in range(seg_len):
            step()
        return state, st["toks"].clone(), st["live"].clone(), \
            {"bad": st["bad"].clone(), "logits0": st["logits0"].clone()}

    segment.runs = box          # the current binding (tests, capture time)
    return segment
