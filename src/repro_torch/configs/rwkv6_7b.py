"""rwkv6-7b [ssm] "Finch": 32L d=4096 attn-free ff=14336 vocab=65536,
data-dependent decay, head_dim 64. [arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv=64, d_ff=14336, vocab=65536, head_dim=64, ssm_head_dim=64,
    norm="rmsnorm", scan_chunk=16,   # two-sided WKV: chunk*DECAY_CLIP <= 80
    source="arXiv:2404.05892; hf")
