"""Mamba2 (SSD) block with scalar-per-head decay, chunked scan, O(1) decode
(port of ``repro/layers/mamba2.py``).

Recurrence per head (state h in R^{P x N}, P = head dim, N = ssm state):

    h_t = exp(dt_t * A) h_{t-1} + (dt_t x_t) B_t^T
    y_t = h_t C_t + D x_t

Chunked evaluation uses the scalar pairwise decay ratio (B,C,C,H); the
state is carried from chunk to chunk by a Python loop.  A depthwise
causal conv (kernel 4) precedes x/B/C; decode (chunk 1) carries the conv
tail and h.  Used by the zamba2-7b hybrid config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .norms import rmsnorm

__all__ = ["init_mamba2_state", "mamba2_block", "CONV_K"]

CONV_K = 4


def init_mamba2_state(batch: int, d_model: int, head_dim: int = 64,
                      ssm_state: int = 64, expand: int = 1,
                      dtype=torch.float32, device=None):
    """The zero state of one layer: the conv tail (B, K-1, d_in + 2N) and
    h (B, H, P, N) f32."""
    d_in = expand * d_model
    H = d_in // head_dim
    return {
        "conv": torch.zeros((batch, CONV_K - 1, d_in + 2 * ssm_state),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, H, head_dim, ssm_state),
                         dtype=torch.float32, device=device),
    }


def _causal_conv(xbc, weight, tail):
    """Depthwise causal conv over time. xbc (B,S,Dc), weight (K,Dc),
    tail (B,K-1,Dc) carries the previous tokens.  The tail and xbc are
    joined in their promoted dtype (an f32 tail makes the rest f32, as
    the reference's concatenation does).  Returns (silu(conv), new tail)."""
    dt = torch.promote_types(tail.dtype, xbc.dtype)
    full = torch.cat([tail.to(dt), xbc.to(dt)], dim=1)
    S = xbc.shape[1]
    out = sum(full[:, i:i + S] * weight[i] for i in range(CONV_K))
    return F.silu(out), full[:, -(CONV_K - 1):]


def _ssd_chunk(h0, x, Bm, Cm, lw, dt):
    """One chunk. h0 (B,H,P,N); x (B,C,H,P), Bm/Cm (B,C,N), lw/dt
    (B,C,H).  Returns (h1, y (B,C,H,P))."""
    C = x.shape[1]
    cum = torch.cumsum(lw, dim=1)                        # (B,C,H)
    # intra: scores[t,s] = exp(cum[t]-cum[s]) * (C_t . B_s) * dt_s  (s<=t)
    ratio = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :],
                                  -60.0, 0.0))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    cb = torch.einsum("btn,bsn->bts", Cm, Bm)            # (B,C,C)
    scores = torch.where(tri, ratio * cb[..., None], 0.0)  # (B,C,C,H)
    scores = scores * dt[:, None, :, :]                  # fold dt_s
    y = torch.einsum("btsh,bshp->bthp", scores, x)
    # inter: y_t += exp(cum[t]) * C_t h0^T
    y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                     Cm, h0)
    # chunk-end state
    kscale = torch.exp(torch.clamp(cum[:, -1:, :] - cum, -60.0, 0.0)) * dt
    h1 = h0 * torch.exp(cum[:, -1])[..., None, None] \
        + torch.einsum("bch,bchp,bcn->bhpn", kscale, x, Bm)
    return h1, y


def mamba2_block(params, x, state, head_dim: int = 64, chunk: int = 64):
    """x (B,S,D) -> (out (B,S,D), new_state); ``state`` is the layer's
    (``init_mamba2_state``), the ssm state width is ``wB``'s.  The chunk
    must divide S (the reference's assert); the state tensors returned
    are new."""
    B, S, D = x.shape
    d_in = params["wx"].shape[1]
    ssm_state = params["wB"].shape[1]
    H = d_in // head_dim
    z = x @ params["wz"]
    xb = x @ params["wx"]
    Bm = x @ params["wB"]
    Cm = x @ params["wC"]
    xbc, conv_tail = _causal_conv(torch.cat([xb, Bm, Cm], dim=-1),
                                  params["conv"], state["conv"])
    xb, Bm, Cm = torch.split(xbc, [d_in, ssm_state, ssm_state], dim=-1)
    f32 = torch.float32
    dt_in = (x @ params["wdt"]) + params["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in)).to(f32)  # softplus
    A = -torch.exp(params["A_log"].to(f32))              # (H,)
    lw = torch.clamp(dt * A[None, None, :], -30.0, -1e-6)   # log decay

    c = min(chunk, S)
    if S % c:
        raise ValueError(f"the SSD chunk {c} must divide the sequence "
                         f"length {S}")
    xh = xb.reshape(B, S, H, head_dim).to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    h, ys = state["h"], []
    for j in range(0, S, c):
        h, y = _ssd_chunk(h, xh[:, j:j + c], Bf[:, j:j + c], Cf[:, j:j + c],
                          lw[:, j:j + c], dt[:, j:j + c])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm"]).to(x.dtype)
    return y @ params["wo"], {"conv": conv_tail, "h": h}
