"""Parameter conversion from the JAX reference.

``params_from_jax`` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested layout, per-layer leaves stacked on
axis 0, as torch tensors.  Both packages then compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> nested dict of torch tensors on
    ``device`` (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(dev)
    return conv(tree)
