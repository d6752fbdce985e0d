"""Family -> model-module registry (port of ``repro/models/registry.py``):
the dense and MoE families share ``models/lm.py``; RWKV6 (ssm) is
``models/rwkv.py`` and Zamba2 (hybrid) ``models/zamba.py``."""
from __future__ import annotations

from ..configs.base import ArchConfig
from . import lm, rwkv, zamba

__all__ = ["get_model"]

_FAMILIES = {"dense": lm, "moe": lm, "ssm": rwkv, "hybrid": zamba}


def get_model(cfg: ArchConfig):
    """The module serving ``cfg``'s family (``init_params``,
    ``cast_layers``, ``prefill``, ``decode``; ``decode_multi`` for the
    attention families)."""
    return _FAMILIES[cfg.family]
