"""RWKV6 "Finch" block (port of ``repro/layers/rwkv6.py``): data-dependent
decay, ddlerp token shift, chunked WKV.

The WKV recurrence per head (state S in R^{dk x dv}):

    out_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t^T
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), per channel)

is evaluated chunk-parallel: within a chunk of C tokens the decay is split
two-sided (``_wkv_chunk``), so the intra-chunk scores are one bf16-operand
product with f32 accumulation, as the reference rounds them; the state
is carried from chunk to chunk by a Python loop.  Under autograd a
chunk's intermediates are recomputed in the backward pass (the
reference's ``remat_chunk``).  Decode is the same block at chunk 1.  The
state is (B, H, dk, dv) whatever the sequence length.

Under a mesh (``par``, a ``parallel.ParallelCtx``) the WKV scan runs on
this rank's heads (over ``model``) and batch rows (over the DP axes),
as the reference's ``shard_fn`` pins its chunk streams
(``P(None, dp, None, tp, None)``), where they divide (``wkv_axes``); the
rank's WKV state is that piece (launch/sharding.py's rule for ``wkv``)
and the heads and rows are gathered before ``ln_x``.  Every head's scan
is independent of the others, so the float path is one device's bits.
The projections run on whole gathered weights (ZeRO-3) on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .norms import rmsnorm
from .remat import remat

__all__ = ["init_rwkv6_state", "wkv6", "wkv_axes", "rwkv6_block",
           "rwkv6_decode", "LORA_R", "DECAY_CLIP"]

LORA_R = 32
# |log w| per step is clipped to DECAY_CLIP: the per-step decay stays
# >= e^-4, and the two-sided chunk form stays inside f32 for
# chunk * DECAY_CLIP <= 80
DECAY_CLIP = 4.0


def wkv_axes(par, batch: int, n_heads: int):
    """(the DP axes the WKV scan's rows are cut over, the axis its heads
    are cut over) under the mesh ``par``, each None where it does not
    divide (or, for the rows, where the batch is the rank's slice
    already: ``ParallelCtx.local_batch``)."""
    if par is None:
        return None, None
    heads = (par.tp_axis,) if n_heads % par.tp_size == 0 else None
    return par.batch_axes(batch), heads


def init_rwkv6_state(batch: int, d_model: int, head_dim: int = 64,
                     dtype=torch.float32, device=None, par=None):
    """The zero state of one layer: the token-shift tails (B, D) and the
    WKV matrices (B, H, dk, dv) f32; under the mesh ``par`` this rank's
    piece of the WKV matrices (``wkv_axes``)."""
    H = d_model // head_dim
    rows, heads = wkv_axes(par, batch, H)
    b = batch if par is None else batch // par.index(rows)[1]
    h = H if par is None else H // par.index(heads)[1]
    return {
        "x_att": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "x_ffn": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((b, h, head_dim, head_dim),
                           dtype=torch.float32, device=device),
    }


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32: the reference's bf16-operand,
    f32-accumulation einsums (products of bf16 values are exact in f32)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mix for the 5 projections (B,S,D)->5x."""
    xxx = x + sx * p["mu"][0]          # base mix for the lora input (w-slot)
    lora = torch.tanh(xxx @ p["maa_w1"]).reshape(*x.shape[:-1], 5, LORA_R)
    mix = torch.einsum("bscr,crd->bscd", lora, p["maa_w2"]) + p["mu"]
    return x[..., None, :] + sx[..., None, :] * mix    # (B,S,5,D)


def _wkv_chunk(S0, r, k, v, lw, u):
    """One chunk of the WKV scan from state S0 (B,H,dk,dv): r/k/lw
    (B,C,H,dk), v (B,C,H,dv), u (H,dk).  Returns (S_new, out (B,C,H,dv)).

    Two-sided bounded form: scores[t,s] = sum_i (r_t e^{cum_{t-1}})_i
    (k_s e^{-cum_s})_i with chunk-local cumsums, whose exponents stay
    within DECAY_CLIP * C."""
    C = r.shape[1]
    cum = torch.cumsum(lw, dim=1)                       # (B,C,H,dk), <= 0
    cum_prev = cum - lw                                 # cum[t-1]
    rA = r * torch.exp(cum_prev)                        # factors <= 1
    kB = k * torch.exp(-cum)
    scores = torch.einsum("bthi,bshi->bhts", _bf16(rA), _bf16(kB))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     -1)
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bthi,hi,bthi->bth", r, u, k)   # bonus (s = t)
    out = torch.einsum("bhts,bshj->bthj", _bf16(scores), _bf16(v)) \
        + diag[..., None] * v
    out = out + torch.einsum("bthi,bhij->bthj", rA, S0)
    kscale = torch.exp(torch.clamp(cum[:, -1][:, None] - cum, -60.0, 0.0))
    S_new = S0 * torch.exp(cum[:, -1])[..., None] \
        + torch.einsum("bshi,bshj->bhij", k * kscale, v)
    return S_new, out


def wkv6(r, k, v, lw, u, state, chunk: int = 32):
    """Chunked WKV scan. r/k/lw (B,S,H,dk), v (B,S,H,dv), u (H,dk),
    state (B,H,dk,dv).  Returns (out (B,S,H,dv), new_state).  The chunk
    must divide S, and chunk * DECAY_CLIP <= 80 (the reference's two
    asserts); the prompt is not padded."""
    S = r.shape[1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"the WKV chunk {c} must divide the sequence "
                         f"length {S}")
    if c * DECAY_CLIP > 80:
        raise ValueError(f"the two-sided WKV form needs chunk * "
                         f"DECAY_CLIP <= 80 for f32, got chunk {c}")
    outs = []
    for j in range(0, S, c):
        state, out = remat(_wkv_chunk, state, r[:, j:j + c],
                           k[:, j:j + c], v[:, j:j + c], lw[:, j:j + c], u)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def rwkv6_block(params, x_res, state, head_dim: int = 64, chunk: int = 32,
                par=None):
    """Full RWKV6 layer: x = x + time_mix(ln1(x)); x = x + channel_mix(ln2(x)).

    x_res (B,S,D) is the residual stream, ``state`` the layer's
    (``init_rwkv6_state``, with ``par``).  Returns (new_residual,
    new_state), the state tensors new (the caller copies them where they
    must live).  ``par``: the scan on this rank's heads and rows (module
    docstring)."""
    B, S, D = x_res.shape
    H = D // head_dim

    # ---- time mix ----
    x = rmsnorm(x_res, params["ln1"])
    prev = torch.cat([state["x_att"][:, None].to(x.dtype), x[:, :-1]], 1)
    sx = prev - x
    mixed = _ddlerp(params, x, sx)                      # (B,S,5,D)
    xw, xk, xv, xr, xg = mixed.unbind(2)
    ww = params["decay_base"] + torch.tanh(xw @ params["decay_w1"]) \
        @ params["decay_w2"]
    lw = -torch.exp(torch.clamp(ww.to(torch.float32), -20.0, 2.0))
    lw = torch.clamp(lw, -DECAY_CLIP, -1e-4)            # log-decay < 0
    f32 = torch.float32
    r = (xr @ params["wr"]).reshape(B, S, H, head_dim)
    k = (xk @ params["wk"]).reshape(B, S, H, head_dim)
    v = (xv @ params["wv"]).reshape(B, S, H, head_dim)
    g = F.silu(xg @ params["wg"])
    rows, heads = wkv_axes(par, B, H)

    def cut(t):                        # (B, S, H, d) -> this rank's piece
        return t if par is None else par.split(par.split(t, rows, 0),
                                               heads, 2)
    u = params["u"].to(f32)
    out, wkv_state = wkv6(cut(r.to(f32)), cut(k.to(f32)), cut(v.to(f32)),
                          cut(lw.reshape(B, S, H, head_dim)),
                          u if par is None else par.split(u, heads, 0),
                          state["wkv"], chunk)
    if par is not None:
        out = par.all_gather(par.all_gather(out, heads, 2), rows, 0)
    out = rmsnorm(out.reshape(B, S, D), params["ln_x"]).to(x.dtype)
    res = x_res + (out * g) @ params["wo"]

    # ---- channel mix ----
    h = rmsnorm(res, params["ln2"])
    prev_f = torch.cat([state["x_ffn"][:, None].to(h.dtype), h[:, :-1]], 1)
    sxf = prev_f - h
    xk_f = h + sxf * params["mu_ffn"][0]
    xr_f = h + sxf * params["mu_ffn"][1]
    kf = torch.square(torch.relu(xk_f @ params["wk_ffn"]))
    ffn = torch.sigmoid(xr_f @ params["wr_ffn"]) * (kf @ params["wv_ffn"])

    new_state = {"x_att": x[:, -1].to(f32), "x_ffn": h[:, -1].to(f32),
                 "wkv": wkv_state}
    return (res + ffn).to(x_res.dtype), new_state


def rwkv6_decode(params, x, state, head_dim: int = 64):
    """O(1) single-token step; x (B,1,D)."""
    return rwkv6_block(params, x, state, head_dim, chunk=1)
