"""Calibrated DS-CIM point-set presets (Sec. IV-C): the pinned winners of
the reference's PRNG/seed search, as the port's own copy.

Values are (kind, seed_u, seed_v, param_u, param_v, trunc)."""
from __future__ import annotations

__all__ = ["CALIBRATED", "calibrated_config"]

CALIBRATED: dict[tuple[str, int, str], tuple] = {
    ("dscim1", 64, "paper"): ("lfsr", 233, 199, 0, 0, "floor"),
    ("dscim1", 128, "paper"): ("lfsr", 91, 23, 1, 0, "floor"),
    ("dscim1", 256, "paper"): ("galois", 199, 91, 1, 0, "floor"),
    ("dscim2", 64, "paper"): ("lfsr", 233, 199, 0, 0, "floor"),
    ("dscim2", 128, "paper"): ("lfsr", 7, 91, 1, 0, "floor"),
    ("dscim2", 256, "paper"): ("galois", 51, 233, 1, 0, "floor"),
    ("dscim1", 64, "opt"): ("r2", 17, 0, None, None, "center"),
    ("dscim1", 128, "opt"): ("sobol", 138, 172, None, None, "center"),
    ("dscim1", 256, "opt"): ("sobol", 0, 60, None, None, "center"),
    ("dscim2", 64, "opt"): ("sobol", 138, 219, None, None, "center"),
    ("dscim2", 128, "opt"): ("r2", 77, 0, None, None, "center"),
    ("dscim2", 256, "opt"): ("r2", 91, 0, None, None, "center"),
}


def calibrated_config(variant: str, length: int, mode: str = "paper"):
    """Build the pinned DSCIMConfig for ('dscim1'|'dscim2', L, 'paper'|'opt')."""
    from .macro import DSCIMConfig
    kind, su, sv, pu, pv, trunc = CALIBRATED[(variant, length, mode)]
    k = 2 if variant == "dscim1" else 3
    name = {"dscim1": "DS-CIM1", "dscim2": "DS-CIM2"}[variant]
    return DSCIMConfig(k=k, length=length, points=kind, seed_u=su, seed_v=sv,
                       param_u=pu, param_v=pv, trunc=trunc,
                       name=f"{name}/L{length}/{mode}")
