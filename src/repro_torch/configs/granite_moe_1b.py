"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) expert_ff=512
vocab=49155, 32 routed top-8, no shared experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv=8, d_ff=512, vocab=49155, head_dim=64,
    mlp_kind="swiglu", norm="rmsnorm", rope_theta=10000.0,
    moe_experts=32, moe_topk=8, moe_shared=0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")
