"""qwen3-1.7b — dense GQA LM with qk_norm [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, d_ff=6144,
    vocab_size=151936, head_dim=128, qk_norm=True,
)
