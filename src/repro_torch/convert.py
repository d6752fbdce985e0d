"""Parameter and state conversion between the JAX reference and the port.

``params_from_jax`` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested layout, per-layer leaves stacked on
axis 0, as torch tensors.  Both packages then compute the same function.
With ``par`` (a ``ParallelCtx``) each rank takes only its piece of every
leaf that the rules of ``launch/sharding.py`` split, cut on the host
before the copy to the device: a rank never holds the whole of a split
matrix, the int8 planes of a prepared weight included (a reference
``QuantizedLinearWeight`` converts to the port's).
``tree_to_numpy`` is the other direction, for parameters and the AdamW
state alike (``{"m", "v", "count"}``): nested dicts of host numpy
copies, which the reference takes as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "tree_to_numpy"]


def params_from_jax(tree, device=None, *, par=None):
    """Nested dict of numpy arrays (prepared weights as the reference's
    ``QuantizedLinearWeight`` of arrays) -> nested dict of torch tensors
    on ``device`` (CUDA unless the caller asks for another).  ``par``:
    each split leaf becomes this rank's ``parallel.Sharded`` piece."""
    from .core.qweights import QuantizedLinearWeight
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, f"{path}/{k}" if path else k)
                    for k, v in t.items()}
        if all(hasattr(t, a) for a in ("q", "scale", "k_orig", "group_k")):
            t = QuantizedLinearWeight(np.asarray(t.q), np.asarray(t.scale),
                                      int(t.k_orig), t.group_k)
        spec = None
        if par is not None:
            from .launch.sharding import placement, shard_for
            spec = placement(path, t, par)
            if spec is not None:
                shape = t.shape
                t = shard_for(par.rank_coords, spec, t)
        if isinstance(t, QuantizedLinearWeight):
            t = QuantizedLinearWeight(tensor(t.q), tensor(t.scale),
                                      t.k_orig, t.group_k)
        else:
            t = tensor(t)
        if spec is None:
            return t
        from .launch.sharding import wrap
        return wrap(t, spec, shape)
    return conv(tree, "")


def tree_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies,
    dtypes kept; a 0-d tensor gives a 0-d array)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True).numpy()
