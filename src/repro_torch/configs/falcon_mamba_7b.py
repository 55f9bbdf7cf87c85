"""falcon-mamba-7b — attention-free Mamba1 LM [arXiv:2410.05355].

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_state=16, mamba_version=1, mlp_type="none",
)
