"""Prepared (quantize-once) DS-CIM linear weights (port of
``repro/core/qweights.py``).

A ``QuantizedLinearWeight`` holds the window-packed int8 planes and
per-window dequant scales a DS-CIM chip keeps resident:

* ``q``     — int8 ``(*stack, nw, g, N)`` window planes (``stack`` carries
              the stacked layer dim);
* ``scale`` — f32 ``(*stack, nw, N)`` per-window dequant scales;
* ``k_orig``/``group_k`` — the unpadded contraction length and the
              requested window granularity.

Integrity digests (``plane_digest`` ... ``restore_weight_plane``): a
prepared model's planes are static for the whole serve, so one digest a
plane, taken with a host golden copy at ``prepare_serving_params(...,
golden=True)``, detects any later bit flip in them; a repair copies the
golden bytes back *into the live tensor*, so a captured graph bound to
its address keeps reading the repaired plane.  Plane order and path
strings are the reference's (its pytree flatten sorts dict keys).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .digest import fold
from .quant import quantize_int8

__all__ = ["QuantizedLinearWeight", "prepare_linear_weight",
           "dequantize_linear_weight", "dscim_patterns", "ties_head",
           "prepare_dscim_params", "split_dscim_mode", "map_params",
           "ELIGIBLE_PATTERNS", "ATTN_PATTERNS", "plane_digest",
           "iter_qweight_planes", "qweight_plane_pieces",
           "weight_plane_index",
           "weight_plane_digests", "golden_weight_copy",
           "restore_weight_plane", "qweight_replicated_specs"]


@dataclasses.dataclass
class QuantizedLinearWeight:
    q: torch.Tensor        # int8 (*stack, nw, g, N)
    scale: torch.Tensor    # f32  (*stack, nw, N)
    k_orig: int
    group_k: int | None

    @property
    def nw(self) -> int:
        return self.q.shape[-3]

    @property
    def g(self) -> int:
        return self.q.shape[-2]

    @property
    def n(self) -> int:
        return self.q.shape[-1]

    @property
    def stack(self) -> tuple:
        return tuple(self.q.shape[:-3])

    @property
    def shape(self) -> tuple:
        return (*self.stack, self.k_orig, self.n)

    def __getitem__(self, i) -> "QuantizedLinearWeight":
        """Slice the stack dims (one layer of a stacked weight)."""
        return QuantizedLinearWeight(self.q[i], self.scale[i], self.k_orig,
                                     self.group_k)


def qweight_replicated_specs(qw: QuantizedLinearWeight
                             ) -> QuantizedLinearWeight:
    """The spec subtree (launch/sharding.py) of a prepared weight that is
    whole on every rank: every dim of its planes and scales ``None``.  The
    MoE shared expert's rule: ``models/lm.py _moe_apply`` runs it on each
    rank's own tokens, with no gather."""
    return QuantizedLinearWeight((None,) * qw.q.ndim, (None,) * qw.scale.ndim,
                                 qw.k_orig, qw.group_k)


def prepare_linear_weight(w: torch.Tensor, group_k: int | None = 128
                          ) -> QuantizedLinearWeight:
    """Float ``(*stack, K, N)`` -> prepared weight (quantize once): K is
    padded with float zeros to whole ``group_k`` windows *before*
    quantizing, one symmetric int8 scale per (window, column)."""
    *stack, K, N = w.shape
    g = group_k or K
    pad = (-K) % g
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    nw = (K + pad) // g
    qt = quantize_int8(w.reshape(*stack, nw, g, N), axis=-2)
    # contiguous planes: a transposed source (the tied head's embed.T)
    # would otherwise leave them strided, and the kernel reads them dense
    return QuantizedLinearWeight(
        qt.q.contiguous(),
        qt.scale.reshape(*stack, nw, N).to(torch.float32).contiguous(),
        K, group_k)


# Name patterns ('a/b/c' paths) of the matrices the DS-CIM serving path
# routes through DSCIMLinear: the MLP matmuls, the MoE shared expert (dense
# on every token) and the LM head.  Attention
# projections are exact unless the spec carries '+attn'.
ELIGIBLE_PATTERNS = (
    "mlp/w_up", "mlp/w_gate", "mlp/w_down",
    "moe/shared/w_up", "moe/shared/w_gate", "moe/shared/w_down",
    "lm_head",
)
ATTN_PATTERNS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")


def dequantize_linear_weight(qw: QuantizedLinearWeight) -> torch.Tensor:
    """Prepared -> float ``(*stack, K, N)`` f32, the pad rows stripped."""
    wf = qw.q.to(torch.float32) * qw.scale[..., :, None, :]
    wf = wf.reshape(*qw.stack, qw.nw * qw.g, qw.n)
    return wf[..., :qw.k_orig, :]


def split_dscim_mode(spec: str) -> tuple[str, bool]:
    """dscim spec -> (base mode, attn opt-in): 'kernel+attn:...' ->
    ('kernel', True); 'off' -> ('off', False)."""
    mode = spec.split(":")[0]
    if mode.endswith("+attn"):
        return mode[:-len("+attn")], True
    return mode, False


def map_params(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict of tensors
    (``QuantizedLinearWeight`` is a leaf); returns a new tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def dscim_patterns(cfg) -> tuple:
    """The name patterns of the matrices ``cfg.dscim`` prepares:
    ``ELIGIBLE_PATTERNS``, and ``ATTN_PATTERNS`` under '+attn'."""
    if split_dscim_mode(cfg.dscim)[1]:
        return ELIGIBLE_PATTERNS + ATTN_PATTERNS
    return ELIGIBLE_PATTERNS


def ties_head(cfg, params) -> bool:
    """Whether preparation makes the head from ``embed.T``: a tied model
    with a token embedding and no ``lm_head``."""
    return (cfg.tie_embeddings and not cfg.stub_frontend
            and "lm_head" not in params)


def prepare_dscim_params(params, cfg, *, group_k: int | None = 128):
    """Convert every DS-CIM-eligible matrix of ``params`` once (serve
    startup); returns a new tree, float originals dropped.  Tied models
    have no ``lm_head``, so a prepared head is materialized from
    ``embed.T`` (the embedding stays float for the lookup).  A '+attn'
    spec adds the attention projections; 'off'/'float' return ``params``.
    An MoE model's router and routed experts stay float; its shared
    expert is prepared."""
    if split_dscim_mode(cfg.dscim)[0] in ("off", "float"):
        return params
    pats = dscim_patterns(cfg)

    def assign(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and any(t in path for t in pats)):
            return prepare_linear_weight(leaf, group_k)
        return leaf

    out = map_params(assign, params)
    if ties_head(cfg, out):
        out["lm_head"] = prepare_linear_weight(params["embed"].T, group_k)
    return out


# --- integrity digests -----------------------------------------------------

def plane_digest(x: torch.Tensor) -> torch.Tensor:
    """The uint32 digest of one plane (core/digest.py, multiplier 1) as an
    int64 scalar tensor: equal to the reference's ``plane_digest``."""
    return fold(x, 0, 1)


def _sorted_leaves(tree, path: str = ""):
    """(path, leaf) over a nested dict in the reference's flatten order:
    dict keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def iter_qweight_planes(params):
    """(path, 'q'|'scale', tensor) for every prepared weight of
    ``params``, in the reference's order: the canonical plane order of
    digest sweeps, golden copies and mismatch attribution.  A placed
    weight (``parallel.Sharded``) gives this rank's pieces of its planes
    (``qweight_plane_pieces`` says where they lie in the whole)."""
    from ..parallel import Sharded
    out = []
    for p, leaf in _sorted_leaves(params):
        if isinstance(leaf, Sharded):
            leaf = leaf.local
        if isinstance(leaf, QuantizedLinearWeight):
            out.append((p, "q", leaf.q))
            out.append((p, "scale", leaf.scale))
    return out


def qweight_plane_pieces(params, par) -> dict:
    """{(path, 'q'|'scale'): (this rank's piece, the whole plane's
    shape, the piece's first index on each dim)} under the mesh ``par``
    (a whole plane's piece is itself): where an element of the whole
    plane lies in this rank's piece (runtime/failover.py's weight
    flips)."""
    from ..parallel import Sharded
    out = {}
    for p, leaf in _sorted_leaves(params):
        spec = None
        if isinstance(leaf, Sharded):
            leaf, spec = leaf.local, leaf.spec
        if not isinstance(leaf, QuantizedLinearWeight):
            continue
        specs = {"q": spec, "scale": None if spec is None
                 else (*spec[:-3], None, spec[-1])}
        for which, t in (("q", leaf.q), ("scale", leaf.scale)):
            whole, start = list(t.shape), [0] * t.ndim
            for d, axes in enumerate(specs[which] or ()):
                if axes:
                    i, n = par.index(axes)
                    whole[d], start[d] = t.shape[d] * n, t.shape[d] * i
            out[(p, which)] = (t, tuple(whole), tuple(start))
    return out


def weight_plane_index(params):
    """[(path, 'q'|'scale'), ...] in ``iter_qweight_planes`` order."""
    return [(p, which) for p, which, _ in iter_qweight_planes(params)]


def weight_plane_digests(params) -> torch.Tensor:
    """(n_planes,) int64 digests in ``weight_plane_index`` order, on the
    planes' device, each digested plane by plane in chunks."""
    planes = iter_qweight_planes(params)
    if not planes:
        return torch.zeros((0,), dtype=torch.int64)
    return torch.stack([plane_digest(x) for _, _, x in planes])


def golden_weight_copy(params) -> dict:
    """Host golden copy of every prepared plane and its digest vector:
    ``{"index", "digests" (np.int64), "planes": {(path, which): CPU
    tensor}}``, the repair's source of truth; of this rank's pieces for
    placed params (each rank keeps the copy of what it holds)."""
    planes = {(p, which): x.to("cpu", copy=True)
              for p, which, x in iter_qweight_planes(params)}
    return {"index": weight_plane_index(params),
            "digests": weight_plane_digests(params).cpu().numpy()
            .astype(np.int64),
            "planes": planes}


def restore_weight_plane(params, path: str, which: str, golden):
    """Copy the (path, which) plane's golden bytes back into the live
    tensor, in place; returns ``params`` (the same tree)."""
    for p, w, x in iter_qweight_planes(params):
        if p == path and w == which:
            x.copy_(golden["planes"][(path, which)])
            return params
    raise KeyError(f"no prepared plane {(path, which)}")
