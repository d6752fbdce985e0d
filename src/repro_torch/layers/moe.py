"""Mixture-of-Experts block with sort-based fixed-capacity dispatch (port
of ``repro/layers/moe.py``, with its expert parallelism on
``torch.distributed``: ``par=``).

Each token picks its top-k experts from an f32 softmax router; the T*k
(token, expert) pairs are sorted by expert (stably, so within an expert
tokens keep their order) and written into per-expert buffers of a static
capacity C = max(int(T*k/E*capacity_factor), k) rows.  A pair beyond its
expert's C rows is dropped: it contributes nothing to its token.  The
expert FFNs run as one batched SwiGLU over the (E, C, D) buffers, and each
token sums its k weighted expert outputs.  A DeepSeek-style shared expert
runs densely on every token through ``layers/mlp.py mlp``, with the
serving path's DS-CIM ``linear`` (its weights are DS-CIM eligible, the
routed experts are not).

Everything is device arithmetic on static shapes: no value is read back
to the host, so a decode step holding this block can be captured in a
CUDA graph.  C depends on T, so a token's output can depend on the other
tokens of its call when capacity drops pairs (never at capacity_factor
>= E/k).

Under a mesh (``par``, a ``parallel.ParallelCtx``: the reference's
``moe(ep_axis=)`` inside ``models/lm.py _moe_apply``'s ``shard_map``) the
routed experts run with expert parallelism: the batch is cut over the DP
axes (where it divides), the experts' weights are ``Sharded`` with the
expert dim over ``model`` and their other dims over the last DP axis,
gathered whole on that axis before use (the explicit ZeRO-3 of the
reference).  Each rank of a ``model`` group routes its slice of the
sequence (all of it when S does not divide, as at decode), fills its
(E, C, D) buffers with C counted from its own tokens, as the reference
counts it per shard, sends each expert's rows to the rank that holds the
expert (``all_to_all``), runs its E / ep experts, sends the outputs back
(``all_to_all``) and combines; the sequence and the batch are then
gathered.  The aux is averaged over the mesh.  Every collective here has
a backward (``parallel.py``), so the train step runs the experts with
expert parallelism too."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mlp import mlp

__all__ = ["moe", "moe_routed", "moe_with_aux", "capacity", "route",
           "dispatch", "load_balance_aux"]


def _router_probs(xs: torch.Tensor, router_w: torch.Tensor):
    """xs (T, D) -> the f32 softmax over the experts (T, E)."""
    return torch.softmax(xs.to(torch.float32) @ router_w.to(torch.float32),
                         dim=-1)


def _pick(probs: torch.Tensor, top_k: int):
    """The top-k experts of each row (descending, as ``jax.lax.top_k``)
    and their probabilities renormalised to sum to 1."""
    top_p, ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    weights = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return ids, weights


def route(xs: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """xs (T, D) -> (ids (T, k) int64, weights (T, k) f32): f32 router
    logits, softmax, top-k, the k probabilities renormalised.  Serving
    leaves the load-balance aux out; ``moe_with_aux`` computes it."""
    return _pick(_router_probs(xs, router_w), top_k)


def load_balance_aux(probs: torch.Tensor, ids: torch.Tensor):
    """The reference's Switch-style load-balance loss, E * sum_e (share of
    the tokens whose first choice is e) * (mean router probability of
    e); probs (T, E), ids (T, k)."""
    E = probs.shape[-1]
    frac = F.one_hot(ids[:, 0], E).to(torch.float32).mean(0)
    return E * torch.sum(frac * probs.mean(0))


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Rows of each expert's buffer for a call of T tokens (static)."""
    return max(int(T * top_k / n_experts * capacity_factor), top_k)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int):
    """Sort-based capacity dispatch of ids (T, k) -> (order (T*k,), slot
    (T*k,), keep (T*k,) bool), all in expert-sorted order: ``order`` maps
    a sorted entry to its flat (token, choice) index, ``slot`` is its row
    of the flattened (E*cap) buffers, or the spare row E*cap where
    ``keep`` is False (the entry came after its expert's cap rows)."""
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    seg_pos = torch.arange(flat.shape[0], device=flat.device)
    experts = torch.arange(n_experts, device=flat.device,
                           dtype=sorted_ids.dtype)
    starts = torch.searchsorted(sorted_ids, experts, right=False)
    pos_in_e = seg_pos - starts[sorted_ids]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_ids * cap + pos_in_e, n_experts * cap)
    return order, slot, keep


def _expert_ffn(we, x: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) through the per-expert SwiGLU FFNs."""
    h = F.silu(torch.bmm(x, we["w_gate"])) * torch.bmm(x, we["w_up"])
    return torch.bmm(h, we["w_down"])


def _experts(params, xt: torch.Tensor, ids, weights, top_k: int,
             capacity_factor: float, ffn=None):
    """The routed experts on the tokens xt (T, D) routed to ``ids`` with
    ``weights``: (out (T, D) in xt's dtype, keep (T*k,) bool in
    expert-sorted order).  ``ffn`` maps the (E, C, D) buffers to their
    expert outputs (default: every expert here, ``_expert_ffn``)."""
    T, D = xt.shape
    E = params["router"].shape[-1]
    C = capacity(T, top_k, E, capacity_factor)
    order, slot, keep = dispatch(ids, E, C)
    tok_idx = order // top_k
    # every kept entry has a row of its own; the dropped ones all write
    # the spare row E*C, where duplicate indices leave any one of their
    # rows, which is harmless only because that row is discarded
    buf = xt.new_zeros((E * C + 1, D))
    # a token's k copies: F.embedding, whose backward sums them in one
    # fixed order on the CPU and on CUDA (an index's adds them with
    # atomics on the CPU)
    buf.index_put_((slot,), F.embedding(tok_idx, xt))
    buf = buf[:-1].reshape(E, C, D)
    out_buf = _expert_ffn(params["experts"], buf) if ffn is None \
        else ffn(buf)
    flat_out = out_buf.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp_max(slot, E * C - 1)], 0.0)
    contrib = gathered * weights.reshape(-1)[order][:, None]
    # combine: the reference scatter-adds each entry (cast to x's dtype)
    # into its token; an atomic index_add_ would reorder the k additions
    # from run to run, so undo the sort instead (the inverse of ``order``)
    # and sum each token's k contributions over a fixed (T, k) axis
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    out_t = contrib.to(xt.dtype)[inv].reshape(T, top_k, D).sum(1)
    return out_t, keep


def _routed_ep(params, x: torch.Tensor, top_k: int, capacity_factor: float,
               par):
    """``moe_routed`` with expert parallelism (module docstring): (out
    (B, S, D), keep of this rank's tokens, aux averaged over the mesh).
    Differentiable: the slices, the exchanges and the gathers are the
    autograd collectives of ``parallel.py``, the router's gradient is
    summed over ``model`` (each rank routes its own slice of the
    sequence) and the experts' gradients stay with the rank that holds
    them."""
    from ..parallel import Sharded
    tp = par.tp_axis
    ep = par.tp_size
    E = params["router"].shape[-1]
    if E % ep:
        raise ValueError(f"{E} experts do not split over {tp}={ep}")
    fsdp = par.dp_axes[-1:]
    we = {}
    for name, w in params["experts"].items():
        if not isinstance(w, Sharded) or w.spec[-3] != (tp,):
            raise ValueError(f"expert parallelism needs the experts' "
                             f"{name} placed with its expert dim over {tp} "
                             "(launch/sharding.py)")
        we[name] = par.gather_spec(w.local, w.spec, only=fsdp)[0]
    b = par.batch_axes(x.shape[0])
    xb = par.split(x, b, 0)
    B, S, D = xb.shape
    split_seq = ep > 1 and S % ep == 0
    if ep > 1 and not split_seq and torch.is_grad_enabled():
        # every rank would route the same tokens and the experts would
        # take ep copies of their gradients
        raise ValueError(f"training with expert parallelism splits the "
                         f"sequence over {tp}: {S} does not divide by {ep}")
    if split_seq:
        xb = par.split(xb, tp, 1)
    xt = xb.reshape(-1, D)
    probs = _router_probs(xt, par.sum_grad(params["router"], tp))
    ids, weights = _pick(probs, top_k)

    def ffn(buf):                                # (E, C, D) on every rank
        buf = par.all_to_all(buf, tp, 0, 1)      # (E/ep, ep*C, D)
        return par.all_to_all(_expert_ffn(we, buf), tp, 1, 0)

    out_t, keep = _experts(params, xt, ids, weights, top_k,
                           capacity_factor, ffn)
    out = out_t.reshape(B, -1, D)
    if split_seq:
        out = par.all_gather(out, tp, 1)
    out = par.all_gather(out, b, 0)
    aux = par.all_reduce_mean(load_balance_aux(probs, ids))
    return out, keep, aux


def moe_routed(params, x: torch.Tensor, *, top_k: int,
               capacity_factor: float = 1.25, par=None):
    """The routed experts alone: x (B, S, D) -> (out (B, S, D) in x's
    dtype, keep (B*S*k,) bool in expert-sorted order; under ``par`` the
    keep of this rank's tokens)."""
    if par is not None:
        return _routed_ep(params, x, top_k, capacity_factor, par)[:2]
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    ids, weights = route(xt, params["router"], top_k)
    out_t, keep = _experts(params, xt, ids, weights, top_k,
                           capacity_factor)
    return out_t.reshape(B, S, D), keep


def _add_shared(params, x, out, has_shared: bool, linear, salt):
    if has_shared:
        out = out + mlp(params["shared"], x, "swiglu", linear=linear,
                        salt=salt)
    return out


def moe(params, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, has_shared: bool = False,
        linear=None, salt=None, par=None) -> torch.Tensor:
    """x (B, S, D) -> out (B, S, D): the routed experts plus, with
    ``has_shared``, the shared expert (``params["shared"]``, SwiGLU,
    whole on every rank) through ``linear`` with ``salt`` (the MLP's call
    sites 0..2).  The reference's ``moe_local`` is this with its own
    default capacity; with ``par`` its ``moe(ep_axis=)``."""
    out, _ = moe_routed(params, x, top_k=top_k,
                        capacity_factor=capacity_factor, par=par)
    return _add_shared(params, x, out, has_shared, linear, salt)


def moe_with_aux(params, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25, has_shared: bool = False,
                 linear=None, salt=None, par=None):
    """``moe`` and the load-balance aux of its routing: (out (B, S, D),
    aux 0-d f32), the reference's ``moe`` at expert parallelism 1 (the
    training forward's MoE block).  In the backward pass every gather
    adds its gradient into distinct rows, or adds zeros (a dropped
    entry), except for a token's k copies, which ``F.embedding``'s
    backward sums in one fixed order: the gradients are the same bits
    from run to run.  ``par``: expert parallelism, the aux averaged over
    the mesh; under the train step's view of the mesh
    (``ParallelCtx.train_view``: the batch is this rank's DP slice) the
    experts are the rank's own, gathered over FSDP by the step, and
    each rank's gradients are those of its slice of the sequence and of
    its experts (launch/steps.py ``_mesh_train_step``)."""
    if par is not None:
        out, _, aux = _routed_ep(params, x, top_k, capacity_factor, par)
        return _add_shared(params, x, out, has_shared, linear, salt), aux
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    probs = _router_probs(xt, params["router"])
    ids, weights = _pick(probs, top_k)
    out_t, _ = _experts(params, xt, ids, weights, top_k, capacity_factor)
    out = _add_shared(params, x, out_t.reshape(B, S, D), has_shared,
                      linear, salt)
    return out, load_balance_aux(probs, ids)
