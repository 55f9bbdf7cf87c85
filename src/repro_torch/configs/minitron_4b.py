"""minitron-4b — pruned nemotron dense LM [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, d_ff=9216,
    vocab_size=256000, head_dim=128,
)
