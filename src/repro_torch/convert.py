"""Parameter and state conversion between the JAX reference and the port.

``params_from_jax`` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested layout, per-layer leaves stacked on
axis 0, as torch tensors.  Both packages then compute the same function.
``tree_to_numpy`` is the other direction, for parameters and the AdamW
state alike (``{"m", "v", "count"}``): nested dicts of host numpy
copies, which the reference takes as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "tree_to_numpy"]


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> nested dict of torch tensors on
    ``device`` (CUDA unless the caller asks for another)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(dev)
    return conv(tree)


def tree_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies,
    dtypes kept; a 0-d tensor gives a 0-d array)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True).numpy()
