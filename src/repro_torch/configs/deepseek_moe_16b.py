"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) expert_ff=1408
vocab=102400, 64 routed top-6 + 2 shared (fine-grained).
[arXiv:2401.06066; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=102400, head_dim=128,
    mlp_kind="swiglu", norm="rmsnorm", rope_theta=10000.0,
    moe_experts=64, moe_topk=6, moe_shared=2,
    source="arXiv:2401.06066; hf")
