"""Architecture registry: --arch <id> resolves here.  The port serves the
reference's dense and MoE families; the RWKV and hybrid architectures
follow."""
from .base import ArchConfig  # noqa: F401

from . import (codeqwen1p5_7b, deepseek_moe_16b, granite_moe_1b,
               musicgen_large, olmo_1b, pixtral_12b, qwen3_0p6b,
               starcoder2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (olmo_1b, qwen3_0p6b, starcoder2_7b, codeqwen1p5_7b,
                   musicgen_large, pixtral_12b, deepseek_moe_16b,
                   granite_moe_1b)}
# the architectures whose inputs are token ids, which the serving loops
# take (the stub-frontend ones take embeddings at the model level)
TOKEN_ARCHS = tuple(n for n, c in ARCHS.items() if not c.stub_frontend)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
