"""codeqwen1.5-7b — dense MHA LM [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, d_ff=13440,
    vocab_size=92416, head_dim=128,
)
