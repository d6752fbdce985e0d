"""GQA attention: chunked online-softmax prefill, dense-cache decode, and
int8 paged-cache decode (port of ``repro/layers/attention.py``), each with
its speculative-verify form over a window of T tokens per row.

Heads are laid out kv-major throughout: query head h = (g, r) with
g = h // n_rep, which is what ``repeat_interleave`` of the kv heads gives
on the dense path and what the paged kernel's (B, KV, n_rep, HD) query
expects.  The decode paths update the caches they are handed in place.

``salt``: the layer's base salt; the projections fold in the reference's
sites 4..7 (q, k, v, o; the MLP owns 0..2), the noise modes' call-site key.
"""
from __future__ import annotations

import torch

from ..core.kvcache import quantize_page
from ..core.dscim_layer import _env_tune
from ..kernels.paged_attention import (NEG_INF, paged_attention_decode,
                                       paged_attention_decode_sharded,
                                       paged_read_plain, use_paged_kernel)
from ..parallel import is_prepared
from .norms import qk_norm
from .rope import apply_rope, rope_angles

__all__ = ["attention", "decode_attention", "decode_attention_multi",
           "decode_attention_paged", "decode_attention_paged_multi",
           "flush_plan", "at", "per_position", "window_mm",
           "window_positions"]


def _mm(x, w, linear, salt=None):
    """Projection matmul: exact by default, DS-CIM when ``linear`` given."""
    if linear is None:
        if is_prepared(w):
            raise TypeError("prepared attention weights need a DS-CIM "
                            "`linear` operator (the '+attn' dscim mode)")
        return x @ w
    return linear(x, w, salt=salt).to(x.dtype)


def at(x, t: int):
    """Position t of a (B, T, ...) window as a contiguous (B, 1, ...)
    tensor: the decode's shape *and* layout (a strided view can take
    another loop, and another summation order, through a reduction)."""
    return x[:, t:t + 1].contiguous()


def per_position(fn, *xs):
    """``fn`` over each position of (B, T, ...) windows at the decode's
    shape and layout (B, 1, ...), concatenated back along T."""
    T = xs[0].shape[1]
    return torch.cat([fn(*(at(x, t) for x in xs)) for t in range(T)],
                     dim=1)


def window_mm(x, w, linear, salt=None):
    """``_mm`` over a (B, T, K) window whose position t must give the bits
    a decode at (B, 1, K) gives: one batched call where ``linear`` is a
    DS-CIM operator whose rows are batch invariant
    (``DSCIMLinear.batch_invariant``), else one call per position (a
    float matmul's summation order may change with M, as cuBLAS's
    algorithm choice does)."""
    if getattr(linear, "batch_invariant", False):
        return _mm(x, w, linear, salt)
    return per_position(lambda xt: _mm(xt, w, linear, salt), x)


def _site(salt, i):
    return None if salt is None else salt + i


def _project(params, x, head_dim, n_kv, linear, salt, mm=_mm):
    """The q/k/v projections (B, S, H|KV, HD), before qk-norm and RoPE."""
    B, S, _ = x.shape
    n_heads = params["wq"].shape[-1] // head_dim
    q = mm(x, params["wq"], linear, _site(salt, 4))
    k = mm(x, params["wk"], linear, _site(salt, 5))
    v = mm(x, params["wv"], linear, _site(salt, 6))
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim), v.reshape(B, S, n_kv, head_dim))


def _qk_rope(params, q, k, positions, head_dim, rope_theta, use_qk_norm):
    if use_qk_norm:
        q = qk_norm(q, params.get("q_norm"))
        k = qk_norm(k, params.get("k_norm"))
    cos, sin = rope_angles(positions, head_dim, rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _qkv(params, x, cfg, positions, linear=None, salt=None):
    q, k, v = _project(params, x, cfg.head_dim, cfg.n_kv, linear, salt)
    q, k = _qk_rope(params, q, k, positions, cfg.head_dim, cfg.rope_theta,
                    cfg.qk_norm)
    return q, k, v


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32: the reference's bf16-operand,
    f32-accumulation einsums (products of bf16 values are exact in f32)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _flash(q, k, v, q_pos, kv_pos, q_chunk: int, kv_chunk: int, n_rep: int):
    """Online-softmax attention. q (B,S,H,D); k/v (B,T,Hkv,D); GQA grouped,
    q/k/p/v rounded to bf16 with f32 statistics, as the reference does.
    Square causal chunks walk only the lower-triangle (q, kv) chunk pairs.
    Returns (B,S,H,D) in q's dtype."""
    B, S, H, D = q.shape
    T = k.shape[1]
    G = k.shape[2]
    scale = D ** -0.5
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    nq, nk = S // q_chunk, T // kv_chunk
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"chunks must divide: {(S, T, q_chunk, kv_chunk)}")
    qc = q.reshape(B, nq, q_chunk, G, n_rep, D).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nk, kv_chunk, G, D).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, G, D).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, q_chunk)
    kp = kv_pos.reshape(nk, kv_chunk)
    lower_only = S == T and q_chunk == kv_chunk and nq == nk
    outs = []
    for i in range(nq):
        acc = torch.zeros((B, G, n_rep, q_chunk, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, G, n_rep, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for j in range(i + 1 if lower_only else nk):
            # q is rounded in every (i, j) pair, as the reference rounds
            # it: the same forward bits, and under autograd q's gradient
            # is rounded to bf16 a pair, then summed, as the reference's
            s = torch.einsum("bgrqd,bgkd->bgrqk", _bf16(qc[i]),
                             _bf16(kc[j])) * scale
            s = torch.where(qp[i][:, None] >= kp[j][None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", _bf16(p), _bf16(vc[j]))
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs)                      # (nq, B, G, R, cq, D)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, D).to(q.dtype)


def attention(params, x, cfg, positions=None, q_chunk: int = 512,
              return_kv: bool = False, linear=None, salt=None):
    """Full-sequence (prefill) GQA attention block.  Returns
    (out, (k, v)) with the cacheable projections, or (out, None)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _qkv(params, x, cfg, positions, linear, salt)
    n_rep = q.shape[2] // cfg.n_kv
    pos1 = positions[0]
    out = _flash(q, k, v, pos1, pos1, q_chunk, q_chunk, n_rep)
    out = _mm(out.reshape(B, S, -1), params["wo"], linear, _site(salt, 7))
    return (out, (k, v)) if return_kv else (out, None)


def _dense_step(q, k, v, cache_k, cache_v, pos, head_dim):
    """One position of dense decode attention: write k/v (B,1,KV,HD) at
    each row's ``pos`` in place, attend with the ragged mask.  q
    (B,1,H,HD) post-RoPE.  Returns (B,1,H*HD) f32."""
    B = q.shape[0]
    T = cache_k.shape[1]
    rows = torch.arange(B, device=q.device)
    cache_k[rows, pos.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos.long()] = v[:, 0].to(cache_v.dtype)
    mask = torch.arange(T, device=q.device)[None, None, None, :] \
        <= pos[:, None, None, None]
    n_rep = q.shape[2] // cache_k.shape[2]
    kr = torch.repeat_interleave(cache_k, n_rep, dim=2)
    vr = torch.repeat_interleave(cache_v, n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     kr.to(torch.float32)) * head_dim ** -0.5
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return out.reshape(B, 1, -1)


def decode_attention(params, x, cache_k, cache_v, pos, cfg, linear=None,
                     salt=None):
    """Single-token decode against a dense cache, written in place.

    x (B,1,D); cache_k/v (B, T, KV, HD); pos (B,) per-slot valid prefix
    lengths (each row writes and masks at its own position).
    Returns out (B,1,D)."""
    q, k, v = _qkv(params, x, cfg, pos[:, None], linear, salt)
    out = _dense_step(q, k, v, cache_k, cache_v, pos, cfg.head_dim)
    return _mm(out.to(x.dtype), params["wo"], linear, _site(salt, 7))


def window_positions(pos, T: int, done=None):
    """The positions of a T-token window per row: pos + t, frozen at pos
    for ``done`` rows (they write and mask at pos, as a done decode
    does).  Returns a list of T (B,) int32 tensors."""
    step = torch.ones_like(pos) if done is None else (~done).to(pos.dtype)
    return [pos + step * t for t in range(T)]


def decode_attention_multi(params, x, cache_k, cache_v, pos, cfg,
                           linear=None, salt=None, done=None):
    """Speculative-verify decode against a dense cache: T consecutive
    tokens per row.  The projections run through ``window_mm`` (batched
    where the operator's rows are batch invariant); qk-norm, RoPE and the
    cache write / mask / softmax run per position, replaying
    ``decode_attention``'s op sequence at its shapes, so position t is
    bitwise t successive single-token decodes.  x (B, T, D); pos (B,);
    ``done`` rows freeze their positions.  Returns out (B, T, D)."""
    T = x.shape[1]
    pts = window_positions(pos, T, done)
    q, k, v = _project(params, x, cfg.head_dim, cfg.n_kv, linear, salt,
                       mm=window_mm)
    outs = []
    for t, pt in enumerate(pts):
        qt, kt = _qk_rope(params, at(q, t), at(k, t), pt[:, None],
                          cfg.head_dim, cfg.rope_theta, cfg.qk_norm)
        outs.append(_dense_step(qt, kt, at(v, t), cache_k, cache_v, pt,
                                cfg.head_dim))
    out = torch.cat(outs, dim=1).to(x.dtype)
    return window_mm(out, params["wo"], linear, _site(salt, 7))


def flush_plan(page_table, pos, ps: int, done=None):
    """Where one decode step's tail flush writes, the same for every layer:
    (phys (B,) the physical page of each slot's tail, hit (B,) whether a
    live slot flushes into that page this step, frm (B,) which slot).

    Live slots whose tail just filled flush their quantized tail.  The
    scatter has a row per slot (no host sync, so it can be captured in a
    CUDA graph), and each row carries the value its page must end with:
    the page a live slot flushes into it, else the page's own contents.
    A done slot's stale table row can name a page that was re-granted to
    a live slot (continuous batching); its row then carries that slot's
    flush too, so rows that share an index write one value and no
    duplicate can win over the flush."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    full = (pos + 1) % ps == 0
    if done is not None:
        full = full & ~done
    phys = page_table[rows, (pos // ps).long()].long()
    src = (phys[:, None] == phys[None, :]) & full[None, :]  # b's page <- c
    return phys, src.any(1), src.to(torch.int32).argmax(1)


def _paged_step(view, q, k, v, pos, plan, done=None, par=None,
                paged_attn: str = "auto"):
    """One position of paged decode attention, in place on ``view``:

    1. the new token k/v (B,1,KV,HD) is written to each slot's tail at
       ``pos % ps``;
    2. the page walk reads pages + tail (``paged_attention_decode``: the
       CUDA kernel on the card, its plain version on the CPU; under
       ``REPRO_DSCIM_TUNE`` at the tile autotuner's winner), or where
       ``paged_attn`` pins 'jnp' (``use_paged_kernel``) the plain read
       ``paged_read_plain`` on any device;
    3. a tail that just filled is quantized once and flushed to its
       physical page (``plan``: ``flush_plan`` at ``pos``; done slots
       neither write nor flush, and a done slot's stale table row never
       overwrites a live slot's flush).

    ``par`` (a ``ParallelCtx``): the read is placed on the mesh
    (``paged_attention_decode_sharded``: each rank reads its slots over
    the DP axes, the output gathered); the cache is whole on every rank.

    q (B,1,H,HD) post-RoPE.  Returns (B,1,H*HD) f32."""
    B = q.shape[0]
    k_pages, v_pages = view["k_pages"], view["v_pages"]
    k_scale, v_scale = view["k_scale"], view["v_scale"]
    k_tail, v_tail = view["k_tail"], view["v_tail"]
    ps, KV, HD = k_pages.shape[1:]
    rows = torch.arange(B, device=q.device)
    off = (pos % ps).long()
    for tail, val in ((k_tail, k), (v_tail, v)):
        new = val[:, 0].to(tail.dtype)
        if done is not None:
            new = torch.where(done[:, None, None], tail[rows, off], new)
        tail[rows, off] = new

    n_rep = q.shape[2] // KV
    qf = q[:, 0].to(torch.float32).reshape(B, KV, n_rep, HD).contiguous()
    args = (qf, k_pages, v_pages, k_scale, v_scale, k_tail, v_tail,
            view["page_table"], pos)
    kernel = use_paged_kernel(paged_attn)
    if par is not None:
        out = paged_attention_decode_sharded(
            *args, par=par, dp_axes=par.dp_axes, tune=_env_tune(),
            plain=not kernel)
    elif kernel:
        out = paged_attention_decode(*args, tune=_env_tune())
    else:
        out = paged_read_plain(*args)

    phys, hit, frm = plan
    for tail, pages, scales in ((k_tail, k_pages, k_scale),
                                (v_tail, v_pages, v_scale)):
        qt, st = quantize_page(tail)
        pages[phys] = torch.where(hit[:, None, None, None], qt[frm],
                                  pages[phys])
        scales[phys] = torch.where(hit[:, None], st[frm], scales[phys])
    return out.reshape(B, 1, -1)


def decode_attention_paged(params, x, view, cfg, linear=None, salt=None,
                           done=None, par=None):
    """Single-token decode against one layer of the int8 paged KV cache.

    ``view`` holds one layer's k/v_pages (P, ps, KV, HD) int8, k/v_scale
    (P, KV) f32, k/v_tail (B, ps, KV, HD) bf16 and the shared page_table
    (B, MP) int32 and pos (B,) int32, and optionally the step's
    ``flush_plan`` under "flush" (computed here when absent).  The tail
    write, page walk and flush are ``_paged_step``'s.  The view's tensors
    are updated in place; pos advances at the model level.  Returns out
    (B,1,D)."""
    pos = view["pos"]
    q, k, v = _qkv(params, x, cfg, pos[:, None], linear, salt)
    plan = view["flush"] if "flush" in view \
        else flush_plan(view["page_table"], pos, view["k_pages"].shape[1],
                        done)
    out = _paged_step(view, q, k, v, pos, plan, done, par,
                      getattr(cfg, "paged_attn", "auto"))
    return _mm(out.to(x.dtype), params["wo"], linear, _site(salt, 7))


def decode_attention_paged_multi(params, x, view, cfg, linear=None,
                                 salt=None, done=None, par=None):
    """Speculative-verify decode against one layer of the int8 paged
    cache: T consecutive tokens per row.

    The projections run through ``window_mm`` (batched where the
    operator's rows are batch invariant); qk-norm, RoPE and the tail
    write / page walk / flush run per position, replaying
    ``decode_attention_paged`` at its shapes (write the tail at
    ``pt % ps``, read through the kernel at B rows with ``pt`` as the
    ragged mask, which is how the kernel's masking covers in-flight draft
    positions, then the quantize-once flush when ``pt`` fills a page), so
    position t is bitwise t successive single-token decodes.  ``done``
    rows freeze ``pt`` and suppress writes and flushes.

    ``view`` as for ``decode_attention_paged``, plus optionally
    "window": the T (pt, flush_plan) pairs, the same for every layer
    (computed here when absent).  Also returns the window's K/V in the
    tail dtype, which the speculative rollback (``core/kvcache.py
    spec_rollback``) needs to rebuild the committed tail.

    Returns (out (B, T, D), (win_k, win_v) (B, T, KV, HD))."""
    T = x.shape[1]
    ps = view["k_pages"].shape[1]
    steps = view.get("window")
    if steps is None:
        steps = [(pt, flush_plan(view["page_table"], pt, ps, done))
                 for pt in window_positions(view["pos"], T, done)]
    q, k, v = _project(params, x, cfg.head_dim, cfg.n_kv, linear, salt,
                       mm=window_mm)
    outs, wk, wv = [], [], []
    for t, (pt, plan) in enumerate(steps):
        qt, kt = _qk_rope(params, at(q, t), at(k, t), pt[:, None],
                          cfg.head_dim, cfg.rope_theta, cfg.qk_norm)
        vt = at(v, t)
        outs.append(_paged_step(view, qt, kt, vt, pt, plan, done, par,
                                getattr(cfg, "paged_attn", "auto")))
        wk.append(kt.to(view["k_tail"].dtype))
        wv.append(vt.to(view["v_tail"].dtype))
    out = torch.cat(outs, dim=1).to(x.dtype)
    out = window_mm(out, params["wo"], linear, _site(salt, 7))
    return out, (torch.cat(wk, dim=1), torch.cat(wv, dim=1))
