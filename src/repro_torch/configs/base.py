"""ArchConfig: one dataclass describing an architecture, its input-shape
set and its reduced smoke-test variant (port of ``repro/configs/base.py``).
``input_specs`` gives ``meta`` tensors where the reference gives
``ShapeDtypeStruct``s: shapes and dtypes, nothing allocated.

``paged_attn`` is the port's own field: the int8 paged read the serving
loops take ('auto' | 'kernel' | 'jnp', ``kernels/paged_attention.py
use_paged_kernel``), which the reference threads through its decode
batch.  Carried by the config, it is part of every step builder's and
captured graph's key."""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ArchConfig", "LM_SHAPES", "Shape", "PAGED_ATTN"]

PAGED_ATTN = ("auto", "kernel", "jnp")


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    batch: int
    kind: str              # train | prefill | decode
    subquadratic_only: bool = False


# The assigned LM shape set (same for all 10 archs).
LM_SHAPES = (
    Shape("train_4k", 4096, 256, "train"),
    Shape("prefill_32k", 32768, 32, "prefill"),
    Shape("decode_32k", 32768, 128, "decode"),
    Shape("long_500k", 524288, 1, "decode", subquadratic_only=True),
)


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
    shapes: tuple = LM_SHAPES
    source: str = ""
    # DS-CIM serving path: "off" or "<mode>:<variant>:<L>[:<calib>]",
    # e.g. "kernel:dscim1:256"
    dscim: str = "off"
    # stuck-at macro fault of the DS-CIM linears, '' = healthy, else
    # "stuck:<stride>:<value>" (models/lm.py _parse_fault; armed by
    # runtime/failover.py FailureInjector.macro_fault_at)
    dscim_fault: str = ""
    # the int8 paged read of the serving loops (module docstring)
    paged_attn: str = "auto"

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab / self.vocab_pad_mult) * self.vocab_pad_mult

    @property
    def q_heads(self) -> int:
        """The q heads as laid out in ``wq``: n_heads padded to
        ``head_pad_to`` (pad heads have zero wq columns and wo rows)."""
        return max(self.n_heads, self.head_pad_to or self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def shape(self, name: str) -> Shape:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name}")

    def runnable(self, shape_name: str) -> bool:
        s = self.shape(shape_name)
        return self.is_subquadratic or not s.subquadratic_only

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

    def input_specs(self, shape_name: str):
        """(kind, batch) for the step of ``shape_name``: the batch's leaves
        are ``meta`` tensors of the reference's shapes and dtypes (int32
        ids, bf16 embeddings for a stub frontend)."""
        s = self.shape(shape_name)

        def f(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        i32, bf16 = torch.int32, torch.bfloat16
        if s.kind == "train":
            if self.stub_frontend:
                batch = {"embeds": f((s.batch, s.seq, self.d_model), bf16),
                         "labels": f((s.batch, s.seq), i32)}
            else:
                batch = {"tokens": f((s.batch, s.seq), i32),
                         "labels": f((s.batch, s.seq), i32)}
        elif s.kind == "prefill":
            if self.stub_frontend:
                batch = {"embeds": f((s.batch, s.seq, self.d_model), bf16)}
            else:
                batch = {"tokens": f((s.batch, s.seq), i32)}
        elif s.kind == "decode":
            if self.stub_frontend:
                batch = {"embed": f((s.batch, 1, self.d_model), bf16)}
            else:
                batch = {"token": f((s.batch,), i32)}
        else:
            raise ValueError(s.kind)
        return s.kind, batch

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        attn = D * self.n_heads * self.head_dim * 2 \
            + D * self.n_kv * self.head_dim * 2
        if self.family == "moe":
            ff = self.moe_experts * 3 * D * F + D * self.moe_experts \
                + self.moe_shared * 3 * D * F
        elif self.mlp_kind == "swiglu":
            ff = 3 * D * F
        else:
            ff = 2 * D * F
        if self.family == "ssm":                      # rwkv6
            per_layer = 5 * D * D + 2 * D * F + D * F  # approx: 5 proj + ffn
        elif self.family == "hybrid":
            per_layer = 2 * D * D + 2 * D * self.ssm_state + D * D
        else:
            per_layer = attn + ff
        total = self.n_layers * per_layer
        if self.family == "hybrid":                   # one shared attn block
            total += attn
        emb = (0 if self.stub_frontend else V * D) + V * D
        return int(total + emb)

    def active_param_count(self) -> int:
        """MoE: active params per token (top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        attn = D * self.n_heads * self.head_dim * 2 \
            + D * self.n_kv * self.head_dim * 2
        ff_active = (self.moe_topk + self.moe_shared) * 3 * D * F \
            + D * self.moe_experts
        emb = (0 if self.stub_frontend else self.vocab * D) + self.vocab * D
        return int(self.n_layers * (attn + ff_active) + emb)
