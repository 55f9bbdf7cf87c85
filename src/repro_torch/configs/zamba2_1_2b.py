"""zamba2-1.2b — Mamba2 + shared attention hybrid [arXiv:2411.15242].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.  One
SHARED attention+MLP block applied after every 6 Mamba2 layers (the
Zamba2 shared-block pattern).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, mamba_version=2, ssm_head_dim=64,
    attn_every=6, head_dim=64,
)
