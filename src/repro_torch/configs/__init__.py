"""Architecture registry: --arch <id> resolves here.  The port serves the
dense qwen3-0.6b family so far; the other reference architectures follow."""
from .base import ArchConfig  # noqa: F401

from . import qwen3_0p6b

ARCHS = {m.CONFIG.name: m.CONFIG for m in (qwen3_0p6b,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
