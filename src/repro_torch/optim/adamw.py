"""AdamW with f32 moments, global-norm clipping and LR schedules (port of
``repro/optim/adamw.py``), as plain functions over the port's nested-dict
trees; no ``torch.optim`` class.

The arithmetic is the reference's: ``count`` is incremented before the
schedule reads it, the gradients are clipped to ``clip_norm`` by their
global norm (``+ 1e-9``), the moments are f32 with bias correction
``1 - b ** count``, and the update is done in f32 and cast back to the
parameter's dtype.  The state is ``{"m", "v", "count"}`` (``count`` a 0-d
int32 tensor beside the parameters), so a checkpoint of it has the
reference's leaves.

``update`` writes the parameters, the moments and ``count`` in place and
returns the same trees (the reference returns new ones): the caller
holds one copy of each, and every scalar stays on the device, so an
update waits on nothing on the host.

Under a mesh (launch/steps.py ``make_train_step(par=)``) a parameter is a
``parallel.Sharded`` piece: ``init`` gives it moments that mirror the
piece (``Sharded`` of the same spec), and ``update`` takes this rank's
gradient pieces (plain tensors) with the global norm of the whole
gradients passed in as ``gnorm``, since a piece's norm is not the
clip's.  The update is elementwise, so a piece updates to the bits of
its part of the whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..parallel import Sharded
from ..tree import leaves

__all__ = ["AdamW", "cosine_schedule", "linear_warmup", "global_norm"]

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares
    (whole leaves: a ``Sharded`` piece's norm is not the leaf's)."""
    sq = []
    for x in leaves(tree):
        if isinstance(x, Sharded):
            raise TypeError("global_norm of a placed piece; pass the whole "
                            "gradients' norm (AdamW.update gnorm=)")
        sq.append(torch.sum(torch.square(x.to(F32))))
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _local(x) -> torch.Tensor:
    return x.local if isinstance(x, Sharded) else x


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr``, then a cosine down to ``floor`` of
    it at ``total``; the step and the result are f32 tensors."""
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_warmup(base_lr: float, warmup: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        return base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        """Zero f32 moments shaped as ``params`` (a ``Sharded`` piece's
        mirror its piece) and ``count`` 0 on their device."""
        def zeros(t):
            if isinstance(t, dict):
                return {k: zeros(v) for k, v in t.items()}
            if isinstance(t, Sharded):
                return Sharded(zeros(t.local), t.spec, t.shape)
            return torch.zeros(t.shape, dtype=F32, device=t.device)
        dev = _local(next(iter(leaves(params)))).device
        return {"m": zeros(params), "v": zeros(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, params, grads, state, step=None, gnorm=None):
        """One step, in place: returns (params, state, the gradients'
        global norm before clipping).  ``grads`` is consumed (scaled in
        place where it is f32); under a mesh it holds this rank's pieces
        and ``gnorm`` the whole gradients' global norm (computed here from
        ``grads`` when None)."""
        count = state["count"]
        count.add_(1)
        step = count if step is None else step
        lr = self.lr(step) if callable(self.lr) else self.lr

        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        c = count.to(F32)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            p, g, m, v = _local(p), _local(g), _local(m), _local(v)
            g = g.to(F32).mul_(scale)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = torch.div(m, bc1).div_(
                torch.div(v, bc2).sqrt_().add_(self.eps))
            p32 = p.to(F32)
            p32.sub_(upd.add_(p32, alpha=self.weight_decay).mul_(lr))
            if p32 is not p:
                p.copy_(p32)
        return params, state, gnorm
