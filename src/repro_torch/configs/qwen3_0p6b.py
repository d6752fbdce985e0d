"""qwen3-0.6b [dense]: 28L d=1024 16H (GQA kv=8) ff=3072 vocab=151936.
qk_norm, GQA, head_dim=128 (projected), tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024, n_heads=16,
    n_kv=8, d_ff=3072, vocab=151936, head_dim=128, mlp_kind="swiglu",
    norm="rmsnorm", qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    source="hf:Qwen/Qwen3-0.6B; hf")
