"""Serving steps (port of ``prepare_serving_params`` and
``make_generate_fn`` from ``repro/launch/steps.py``).

``prepare_serving_params`` converts every DS-CIM-eligible weight once into
resident int8 ``QuantizedLinearWeight`` planes.  ``make_generate_fn``
builds the generation loop: prefill, then up to ``n_tokens - 1`` greedy
decode steps, either fixed-length or with an EOS early exit.  The
reference runs the loop inside one jitted ``lax.scan``/``while_loop``;
here it is a Python loop of eager steps (capturing it in a CUDA graph is
later work).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.qweights import prepare_dscim_params, split_dscim_mode
from ..models import lm

__all__ = ["prepare_serving_params", "make_generate_fn"]

PAD_ID = 0          # token written for finished slots


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


def make_generate_fn(cfg: ArchConfig, n_tokens: int = 16, *,
                     trace_logits: bool = False, eos_id: int | None = None,
                     kv: str = "float", page_size: int = 8):
    """Greedy generation: ``generate(params, tokens, max_new=None)`` with
    tokens (B, S) int -> ``(out (B, n_tokens) int32, logits, cache)``.

    ``logits`` is the prefill last-token logits (B, Vp), or under
    ``trace_logits`` the stacked per-step trace (n_tokens, B, Vp)
    (fixed-length loop only).  ``cache`` is the final KV cache.

    ``eos_id``: stop as soon as every slot has emitted ``eos_id`` (or hit
    its optional ``max_new`` (B,) budget, counted including the prefill
    token); finished slots stop advancing and their remaining tokens are
    ``PAD_ID``.  ``kv``: 'float' dense cache or 'int8' block-paged cache
    (``page_size`` tokens per page, pool sized for prompt + generation).
    """
    _check_kv(cfg, kv)
    if trace_logits and eos_id is not None:
        raise ValueError("trace_logits is a fixed-length-loop feature")

    def _prefill(params, tokens):
        B, S = tokens.shape
        if kv == "float":
            return lm.prefill(params, cfg, tokens, capacity=S + n_tokens)
        from ..core.kvcache import n_pages_for, paged_from_dense
        logits0, dense = lm.prefill(params, cfg, tokens)
        mp = n_pages_for(S + n_tokens, page_size)
        return logits0, paged_from_dense(dense["k"], dense["v"], page_size,
                                         n_pages=B * mp, max_pages=mp)

    def nxt(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(params, tokens: torch.Tensor, max_new=None):
        B = tokens.shape[0]
        logits0, cache = _prefill(params, tokens)
        tok = nxt(logits0)
        out = torch.full((B, n_tokens), PAD_ID, dtype=torch.int32,
                         device=tokens.device)
        out[:, 0] = tok
        if eos_id is None:
            trace = [logits0]
            for i in range(1, n_tokens):
                logits, cache = lm.decode(params, cfg, tok, cache)
                tok = nxt(logits)
                out[:, i] = tok
                if trace_logits:
                    trace.append(logits)
            return out, (torch.stack(trace) if trace_logits
                         else logits0), cache
        done = tok == eos_id
        if max_new is not None:
            done = done | (max_new <= 1)
        i = 1
        while i < n_tokens and not bool(done.all()):
            logits, cache = lm.decode(params, cfg, tok, cache, done=done)
            new = torch.where(done, torch.full_like(tok, PAD_ID),
                              nxt(logits))
            ndone = done | (new == eos_id)
            if max_new is not None:
                ndone = ndone | (i + 1 >= max_new)
            out[:, i] = new
            tok, done = new, ndone
            i += 1
        return out, logits0, cache

    return generate
