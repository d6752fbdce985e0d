"""starcoder2-7b [dense]: 32L d=4608 36H (GQA kv=4) ff=18432 vocab=49152.
GQA + RoPE; GELU MLP (starcoder2 uses gelu, non-gated).
[arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv=4, d_ff=18432, vocab=49152, head_dim=128,
    head_pad_to=48,  # 36 heads pad to 48 for clean 16-way TP (zero wo rows)
    mlp_kind="gelu", norm="layernorm", rope_theta=1e5,
    source="arXiv:2402.19173; hf")
