"""Sharding rules: parameter tree -> spec tree, cache -> spec tree, batch
-> spec tree (port of ``repro/launch/sharding.py``), and the cut of one
rank's piece.

A spec is a tuple with one entry per dim of the whole leaf: ``None``
(whole on every rank) or the tuple of mesh axes the dim is split over,
the first major (a bare axis name of the reference's ``PartitionSpec``
is a 1-tuple here).  The rules are the reference's, name-based over the
'a/b/c' paths of the parameter tree, with its divisibility fallbacks:

* TP (``model``): attention QKV and MLP up/gate split their columns, O and
  down their rows; the embedding and the head split the vocabulary; MoE
  experts split over ``model`` (expert parallelism);
* FSDP (the last DP axis, ``data``): every large matrix also splits its
  other dim;
* DP: batch dims;
* prepared DS-CIM weights (``QuantizedLinearWeight``): the int8 planes
  (*, nw, g, N) and scales (*, nw, N) split N over ``model`` (quantization
  windows stay whole on K), except a prepared MoE shared expert, which is
  whole on every rank (``core/qweights.py qweight_replicated_specs``).

``shard_for`` cuts one rank's piece of a leaf by its spec and
``shard_params`` places a whole tree: a leaf some dim of which is split
becomes a ``parallel.Sharded`` (its piece and the spec), the rest stay as
they are; ``to_shardings`` does the same by a spec tree (the training
state: ``opt_state_specs``, AdamW's moments placed as the params).  The
port's serving keeps the KV cache whole on every rank (its float math
is the single-device math, and the paged read cuts the batch
itself: ``kernels/paged_attention.py paged_attention_decode_sharded``);
``cache_partition`` and ``batch_specs`` are the reference's rules, kept
for the mesh the cache would take.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..core.qweights import (QuantizedLinearWeight, map_params,
                             qweight_replicated_specs)
from ..parallel import ParallelCtx, Sharded

__all__ = ["param_specs", "opt_state_specs", "batch_specs",
           "cache_partition", "qweight_specs", "shard_for", "shard_params",
           "to_shardings", "place_leaf", "placement", "leaf_spec", "wrap"]

# name -> spec of the trailing dims of the param (stacking dims get None);
# the FSDP axis written as 'F', the tensor axis as 'T'.  First match wins.
_RULES = [
    # generic transformer
    ("embed", ("T", "F")),
    ("lm_head", ("F", "T")),
    ("attn/wq", ("F", "T")), ("attn/wk", ("F", "T")), ("attn/wv", ("F", "T")),
    ("attn/wo", ("T", "F")),
    ("shared_attn/wq", ("F", "T")), ("shared_attn/wk", ("F", "T")),
    ("shared_attn/wv", ("F", "T")), ("shared_attn/wo", ("T", "F")),
    ("mlp/w_up", ("F", "T")), ("mlp/w_gate", ("F", "T")),
    ("mlp/w_down", ("T", "F")),
    # moe (models/lm.py _moe_apply gathers the F dims and keeps T)
    ("moe/router", (None, None)),
    ("moe/experts/w_gate", ("T", None, "F")),
    ("moe/experts/w_up", ("T", None, "F")),
    ("moe/experts/w_down", ("T", "F", None)),
    ("moe/shared/w_gate", (None, "F")), ("moe/shared/w_up", (None, "F")),
    ("moe/shared/w_down", ("F", None)),
    # rwkv6
    ("/wr", ("F", "T")), ("/wk", ("F", "T")), ("/wv", ("F", "T")),
    ("/wg", ("F", "T")), ("/wo", ("T", "F")),
    ("/wk_ffn", ("F", "T")), ("/wv_ffn", ("T", "F")), ("/wr_ffn", ("F", "T")),
    ("maa_w1", ("F", None)), ("decay_w1", ("F", None)),
    # mamba2 / zamba
    ("mamba/wz", ("F", "T")), ("mamba/wx", ("F", "T")),
    ("mamba/wB", ("F", None)), ("mamba/wC", ("F", None)),
    ("mamba/wdt", ("F", None)), ("mamba/wo", ("T", "F")),
]


def _on(axis: str, d: int, sizes: dict):
    """(axis,) if the dim of size d divides over it, else None."""
    return (axis,) if d % sizes[axis] == 0 else None


def leaf_spec(path: str, shape, fsdp: str, tp: str, sizes: dict) -> tuple:
    """The rule for a float leaf at ``path`` of ``shape``."""
    ndim = len(shape)
    for pat, dims in _RULES:
        if pat in path:
            lead = ndim - len(dims)
            spec = [None] * lead
            for ax, d in zip(dims, shape[lead:]):
                if ax == "F":
                    spec.append(_on(fsdp, d, sizes))
                elif ax == "T":
                    spec.append(_on(tp, d, sizes))
                else:
                    spec.append(None)
            return tuple(spec)
    return ()    # small params (norms, biases, ...) whole, the P() rule


def qweight_specs(qw: QuantizedLinearWeight, tp: str, sizes: dict
                  ) -> QuantizedLinearWeight:
    """Spec subtree of one prepared weight: N over the TP axis (where it
    divides), windows, groups and stack dims whole; a
    ``QuantizedLinearWeight`` whose planes are specs."""
    t = _on(tp, qw.q.shape[-1], sizes)
    return QuantizedLinearWeight((None,) * (qw.q.ndim - 1) + (t,),
                                 (None,) * (qw.scale.ndim - 1) + (t,),
                                 qw.k_orig, qw.group_k)


def param_specs(cfg: ArchConfig, par: ParallelCtx, params):
    """Spec tree matching ``params`` (tensors, or anything with
    ``shape``/``ndim``, and prepared weights)."""
    fsdp, tp = par.dp_axes[-1], par.tp_axis

    def assign(path, leaf):
        if isinstance(leaf, QuantizedLinearWeight):
            if "moe/shared" in path:
                # the shared expert runs on every token of every rank's
                # slice: its planes are whole everywhere
                return qweight_replicated_specs(leaf)
            return qweight_specs(leaf, tp, par.sizes)
        return leaf_spec(path, tuple(leaf.shape), fsdp, tp, par.sizes)
    return map_params(assign, params)


def opt_state_specs(pspecs):
    """AdamW's ``m`` and ``v`` mirror the params; ``count`` is whole."""
    return {"m": pspecs, "v": pspecs, "count": ()}


def _div(n: int, axes, sizes: dict) -> bool:
    return n % math.prod(sizes[a] for a in axes) == 0


def batch_specs(cfg: ArchConfig, par: ParallelCtx, batch):
    """Batch dims over DP where they divide; everything else whole."""
    dp = tuple(par.dp_axes)

    def assign(_, leaf):
        if leaf.ndim == 0:
            return ()
        first = dp if _div(leaf.shape[0], dp, par.sizes) else None
        return (first,) + (None,) * (leaf.ndim - 1)
    return map_params(assign, batch)


def cache_partition(cfg: ArchConfig, par: ParallelCtx, cache):
    """KV caches and recurrent states, the reference's rule: k/v (L, B, T,
    kvH, hd) batch over DP (if it divides), kv heads over TP when they
    divide, else the sequence takes TP (and the idle DP axes); the int8
    paged pool over DP; recurrent states' heads over TP."""
    dp = tuple(par.dp_axes)
    tp = par.tp_axis
    sizes = par.sizes
    tp_n = sizes[tp]

    def bdp(n):
        return dp if _div(n, dp, sizes) else None

    def ttp(n):
        return (tp,) if n % tp_n == 0 else None

    def assign(p, leaf):
        shp = tuple(leaf.shape)
        if p.endswith("pos"):
            # a scalar (lockstep decode) is whole; per-slot (B,) positions
            # split over DP with the request batch
            return (bdp(shp[0]),) if len(shp) == 1 else ()
        if "k_pages" in p or "v_pages" in p:      # (L, P, ps, KV, HD)
            return (None, bdp(shp[1]), None, ttp(shp[3]), None)
        if "k_scale" in p or "v_scale" in p:      # (L, P, KV)
            return (None, bdp(shp[1]), ttp(shp[2]))
        if "k_tail" in p or "v_tail" in p:        # (L, B, ps, KV, HD)
            return (None, bdp(shp[1]), None, ttp(shp[3]), None)
        if "page_table" in p:                     # (B, MP)
            return (bdp(shp[0]), None)
        if p in ("k", "v") or p.endswith("/k") or p.endswith("/v"):
            L, B, T, KV, HD = shp
            bspec = bdp(B)
            taxes = []          # axes assigned to the sequence dim
            if bspec is None:
                taxes += list(dp)   # idle DP axes take the sequence
            kvspec = ttp(KV)
            if kvspec is None:
                taxes.append(tp)    # few kv heads: TP splits the sequence
            if taxes and not _div(T, taxes, sizes):
                taxes = []
            return (None, bspec, tuple(taxes) if taxes else None, kvspec,
                    None)
        if "wkv" in p:                            # rwkv state (L,B,H,dk,dv)
            return (None, bdp(shp[1]), ttp(shp[2]), None, None)
        if "x_att" in p or "x_ffn" in p:          # (L, B, D)
            return (None, bdp(shp[1]), ttp(shp[2]))
        if "conv" in p:                           # (nb, mpb, B, K-1, Dc)
            return (None, None, bdp(shp[2]), None, ttp(shp[4]))
        if p.endswith("/h") or p == "mamba/h":    # (nb, mpb, B, H, P, N)
            return (None, None, bdp(shp[2]), ttp(shp[3]), None, None)
        return (None,) * len(shp)
    return map_params(assign, cache)


def shard_for(rank_coords: dict, spec: tuple, t):
    """This rank's piece of ``t`` (a tensor or a numpy array) by ``spec``;
    ``rank_coords`` is {axis: (coordinate, size)}
    (``ParallelCtx.rank_coords``).  A prepared weight's spec is a
    ``QuantizedLinearWeight`` of specs (``q``'s and ``scale``'s).  A
    piece is a view of ``t``."""
    if isinstance(t, QuantizedLinearWeight):
        return QuantizedLinearWeight(shard_for(rank_coords, spec.q, t.q),
                                     shard_for(rank_coords, spec.scale,
                                               t.scale),
                                     t.k_orig, t.group_k)
    for d, axes in enumerate(spec):
        if not axes:
            continue
        i, n = 0, 1
        for a in axes:
            c, s = rank_coords[a]
            i, n = i * s + c, n * s
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{n} ways over {axes}")
        b = t.shape[d] // n
        t = t[(slice(None),) * d + (slice(i * b, (i + 1) * b),)]
    return t


def placement(path: str, leaf, par: ParallelCtx):
    """The rule's spec for a whole leaf (a tensor, an array or a prepared
    weight), or None where it splits no dim (the leaf stays whole)."""
    if isinstance(leaf, QuantizedLinearWeight):
        spec = qweight_replicated_specs(leaf) if "moe/shared" in path \
            else qweight_specs(leaf, par.tp_axis, par.sizes)
        return spec if any(spec.q) else None
    if not hasattr(leaf, "shape"):
        return None
    spec = leaf_spec(path, tuple(leaf.shape), par.dp_axes[-1], par.tp_axis,
                     par.sizes)
    return spec if any(spec) else None


def wrap(piece, spec, shape) -> Sharded:
    """A rank's piece (contiguous), its leaf's spec and whole shape as a
    ``Sharded``."""
    if isinstance(piece, QuantizedLinearWeight):
        return Sharded(QuantizedLinearWeight(
            piece.q.contiguous(), piece.scale.contiguous(), piece.k_orig,
            piece.group_k), spec.q, tuple(shape))
    return Sharded(piece.contiguous(), spec, tuple(shape))


def place_leaf(path: str, leaf, par: ParallelCtx):
    """One whole leaf placed by the rules: a ``Sharded`` of this rank's
    piece where the rule splits a dim, else the leaf.  A leaf already
    placed passes through."""
    if isinstance(leaf, Sharded):
        return leaf
    spec = placement(path, leaf, par)
    if spec is None:
        return leaf
    return wrap(shard_for(par.rank_coords, spec, leaf), spec, leaf.shape)


def shard_params(params, par: ParallelCtx):
    """``params`` placed on ``par`` (``place_leaf`` leaf by leaf); placed
    params come back as they are."""
    return map_params(lambda path, a: place_leaf(path, a, par), params)


def to_shardings(par: ParallelCtx, spec_tree, tree):
    """``tree`` (whole leaves, nested dicts) placed by ``spec_tree`` (the
    same nesting, e.g. ``param_specs`` or ``opt_state_specs``): each leaf
    whose spec splits a dim becomes this rank's ``Sharded`` piece
    (``shard_for`` / ``wrap``), the rest stay whole.  The port's
    counterpart of the reference's ``device_put`` onto
    ``to_shardings(mesh, specs)``."""
    if isinstance(tree, dict):
        return {k: to_shardings(par, spec_tree[k], v)
                for k, v in tree.items()}
    spec = spec_tree
    split = any(spec.q) if isinstance(spec, QuantizedLinearWeight) \
        else any(spec)
    if isinstance(tree, Sharded) or not split:
        return tree
    return wrap(shard_for(par.rank_coords, spec, tree), spec, tree.shape)
