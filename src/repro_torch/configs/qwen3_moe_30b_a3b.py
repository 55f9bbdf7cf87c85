"""qwen3-moe-30b-a3b — MoE LM, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936, qk_norm.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, d_ff=768,
    vocab_size=151936, head_dim=128, qk_norm=True, num_experts=128,
    experts_per_token=8,
)
