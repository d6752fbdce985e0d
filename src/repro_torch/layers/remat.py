"""Rematerialization: the port of the reference's
``jax.checkpoint(..., policy=nothing_saveable)``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["remat"]


def remat(fn, *args, on: bool = True):
    """``fn(*args)``, keeping none of its intermediates for the backward
    pass (they are recomputed from ``args`` there) when ``on`` and
    autograd is recording; a plain call otherwise."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
