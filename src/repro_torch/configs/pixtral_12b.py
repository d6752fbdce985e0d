"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072,
mistral-nemo-style decoder backbone (head_dim=128); pixtral-ViT frontend is
a STUB - the inputs are precomputed patch embeddings (B,S,D).
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, d_ff=14336, vocab=131072, head_dim=128,
    mlp_kind="swiglu", norm="rmsnorm", rope_theta=1e6, stub_frontend=True,
    source="hf:mistralai/Pixtral-12B-2409; unverified")
