"""Family -> model-module registry (port of ``repro/models/registry.py``):
the dense and MoE families share ``models/lm.py``."""
from __future__ import annotations

from ..configs.base import ArchConfig
from . import lm

__all__ = ["get_model"]

_FAMILIES = {"dense": lm, "moe": lm}
# the reference's families the port does not serve yet, and their ports
PENDING_FAMILIES = {"ssm": "RWKV6 (ROADMAP A14c)",
                    "hybrid": "Zamba2 (ROADMAP A14d)"}


def get_model(cfg: ArchConfig):
    """The module serving ``cfg``'s family (``init_params``, ``prefill``,
    ``decode``, ``decode_multi``)."""
    if cfg.family in PENDING_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family, "
                                  f"{PENDING_FAMILIES[cfg.family]}, is "
                                  "not ported yet")
    return _FAMILIES[cfg.family]
