"""ArchConfig: one dataclass describing an architecture and its reduced
smoke-test variant (port of ``repro/configs/base.py`` without the
JAX-only ``input_specs``)."""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    mlp_kind: str = "swiglu"       # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (olmo)
    qk_norm: bool = False
    head_pad_to: int = 0           # pad q heads for clean TP (zero wo rows)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    stub_frontend: bool = False    # inputs are embeddings
    # moe
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0
    moe_capacity: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    mamba_per_block: int = 3
    # execution knobs
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    scan_chunk: int = 64
    cache_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_mult: int = 256
    source: str = ""
    # DS-CIM serving path: "off" or "<mode>:<variant>:<L>[:<calib>]",
    # e.g. "kernel:dscim1:256"
    dscim: str = "off"

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab / self.vocab_pad_mult) * self.vocab_pad_mult

    def reduced(self) -> "ArchConfig":
        """Same family/topology, tiny dims: runs a real step on 1 CPU core."""
        def rd(v, lo, cap):
            return max(lo, min(v, cap))
        return dataclasses.replace(
            self,
            n_layers=2 if self.family != "hybrid" else 4,
            d_model=64,
            n_heads=rd(self.n_heads, 2, 4),
            n_kv=rd(self.n_kv, 1, 2),
            head_dim=16,
            d_ff=96,
            vocab=128,
            vocab_pad_mult=32,
            moe_experts=min(self.moe_experts, 8),
            moe_topk=min(self.moe_topk, 2),
            moe_shared=min(self.moe_shared, 1),
            moe_capacity=8.0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            mamba_per_block=min(self.mamba_per_block, 2),
            q_chunk=8, kv_chunk=8, scan_chunk=4,
            compute_dtype="float32", cache_dtype="float32",
            remat=False,
        )
