"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447].

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.  The modality
frontend (CNN feature extractor) is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d_model), per the brief.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, d_ff=5120,
    vocab_size=504, mlp_type="gelu",
)
