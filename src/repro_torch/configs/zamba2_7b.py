"""zamba2-7b [hybrid]: 81L d=3584 32H (kv=32) ff=14336 vocab=32000,
Mamba2 backbone (ssm_state=64) + shared GQA attention block (weight-shared,
applied once per 3-mamba-layer super-block -> 27 applications).
[arXiv:2411.15242; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv=32, d_ff=14336, vocab=32000, head_dim=112, ssm_state=64,
    ssm_head_dim=64, mamba_per_block=3, norm="rmsnorm", scan_chunk=64,
    source="arXiv:2411.15242; unverified")
