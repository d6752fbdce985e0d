"""musicgen-large [audio]: 48L d=2048 32H (kv=32) ff=8192 vocab=2048,
decoder-only over EnCodec tokens; modality frontend is a STUB -
the inputs are precomputed frame embeddings (B,S,D).  RoPE replaces
the original learned absolute positions (documented adaptation).
[arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="dense", n_layers=48, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=2048, head_dim=64,
    mlp_kind="gelu", norm="layernorm", stub_frontend=True,
    source="arXiv:2306.05284; hf")
