"""codeqwen1.5-7b [dense]: 32L d=4096 32H (kv=32 = MHA) ff=13440 vocab=92416.
qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=32, d_ff=13440, vocab=92416, head_dim=128,
    mlp_kind="swiglu", norm="rmsnorm", rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B; hf")
